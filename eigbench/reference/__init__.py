"""The plain reference: plain PyTorch, no part of the program."""
