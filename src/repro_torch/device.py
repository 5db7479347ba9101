"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card, and raises when there is none: an entry
    point never carries on on the CPU unless the caller passed
    `device="cpu"` (as the CPU tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' explicitly to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device) -> None:
    """Wait until the work queued on `device` has run (nothing to wait
    for on the CPU): a host-clock timing on the card ends here."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_cuda_linalg(device) -> None:
    """Load torch's CUDA linear algebra (its cuSOLVER kernels, which torch
    loads at the first CUDA `torch.linalg` call) on the calling thread; a
    no-op off CUDA. Two threads that make their first such call at once
    both enter the loader, and one fails with "lazy wrapper should be
    called at most once": a server that solves on several threads calls
    this before it starts them."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.linalg.cholesky_ex(torch.ones((1, 1), device=dev))
