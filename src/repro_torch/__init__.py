"""PyTorch/CUDA port of the out-of-core block eigensolver (`repro`).

Mirrors `repro` module for module. Plain tensor code is PyTorch; every
kernel that `repro` wrote in Pallas for the TPU is a hand-written CUDA
kernel for Hopper under `kernels/csrc/`. This package imports neither
JAX nor any module of `repro`. See README.md in this directory.
"""
