"""The harness: cells by name, the window, the check, the result."""
