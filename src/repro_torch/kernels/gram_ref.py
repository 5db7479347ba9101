"""Plain PyTorch version of the Gram / projection op (Anasazi MvTransMv):

    G <- alpha * A^T @ B

A: (n, m), B: (n, b) tall and skinny → G: (m, b), accumulated in float32.
"""
from __future__ import annotations

import torch


def gram_ref(a: torch.Tensor, b: torch.Tensor, *,
             alpha: float = 1.0) -> torch.Tensor:
    return alpha * (a.float().T @ b.float())
