"""Hand-written CUDA kernels (`csrc/`), their wrappers and plain PyTorch
versions; `ops` is the one entry point the rest of the port calls."""
