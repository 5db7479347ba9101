"""The benchmark of the port (`repro_torch`): see README.md."""
