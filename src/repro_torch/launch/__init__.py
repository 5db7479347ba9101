"""repro_torch.launch — command-line entry points (port of `repro.launch`:
the serve and training launchers; the dry-run launcher is ROADMAP queue 1
item 8)."""
