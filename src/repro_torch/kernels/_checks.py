"""Argument checks shared by the kernel wrappers: a wrapper raises on
anything its kernel does not take, before a pointer reaches CUDA."""
from __future__ import annotations

import torch

F32 = (torch.float32,)
F32_BF16 = (torch.float32, torch.bfloat16)


def _names(dtypes) -> str:
    return " or ".join(str(d).removeprefix("torch.") for d in dtypes)


def require_dtype(name: str, dtypes, **tensors: torch.Tensor) -> None:
    """Every tensor of one of `dtypes` (TypeError otherwise). Checked
    before the device, so a refusal reads the same on any device."""
    for arg, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            f"{_names(dtypes)}")


def require_cuda(name: str, **tensors: torch.Tensor) -> torch.device:
    """All tensors contiguous and on one CUDA device; returns it."""
    dev = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel "
                             f"runs on CUDA tensors only")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
    return dev


def require_cuda_f32(name: str, **tensors: torch.Tensor) -> torch.device:
    """All tensors float32, contiguous and on one CUDA device; returns it."""
    require_dtype(name, F32, **tensors)
    return require_cuda(name, **tensors)


def require_int32(name: str, device: torch.device,
                  **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.int32 or t.device != device:
            raise TypeError(f"{name}: {arg} must be int32 on {device}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def require_cuda_float(name: str, **tensors: torch.Tensor) -> torch.device:
    """All tensors of one type, float32 or bf16, on one CUDA device, with a
    contiguous last dim (other strides are free); returns the device."""
    dev = dtype = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, the kernel "
                             f"runs on CUDA tensors only")
        if t.dtype not in F32_BF16:
            raise TypeError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                            f"float32 or bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} needs a contiguous last dim, "
                             f"got strides {t.stride()}")
        if dev is None:
            dev, dtype = t.device, t.dtype
        elif t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                             f"not {dtype} on {dev}")
    return dev
