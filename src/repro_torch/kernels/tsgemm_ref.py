"""Plain PyTorch version of the tall-skinny GEMM (Anasazi MvTimesMatAddMv):

    C <- alpha * A @ B + beta * C0

A: (n, m) tall and skinny, B: (m, b) small, C: (n, b), float32.
"""
from __future__ import annotations

import torch


def tsgemm_ref(a: torch.Tensor, b: torch.Tensor, *, alpha: float = 1.0,
               beta: float = 0.0, c0: torch.Tensor | None = None
               ) -> torch.Tensor:
    out = alpha * (a.float() @ b.float())
    if c0 is not None and beta != 0.0:
        out = out + beta * c0.float()
    return out
