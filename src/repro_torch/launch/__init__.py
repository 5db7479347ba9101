"""repro_torch.launch — command-line entry points (port of `repro.launch`:
the serve launcher; the dry-run and training launchers are ROADMAP queue 1
items 7 and 8)."""
