"""repro_torch.launch — command-line entry points (port of `repro.launch`:
the serve and training launchers, the production mesh shapes, and the
dry run on the meta device with its roofline tables)."""
