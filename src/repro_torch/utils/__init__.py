"""repro_torch.utils — analysis helpers (port of `repro.utils`):
`collective_cost`, the counterpart of the reference's `hlo_analysis`."""
