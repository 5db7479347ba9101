"""Storage backends for the slow tier — the RAM part of
`repro.safs.backend`.

`TieredStore` owns policy (tier residency, LRU demotion, write-avoidance,
logical byte accounting); a backend owns where the slow-tier bytes live.
`RamBackend` keeps them as CPU tensors. When the store's device is CUDA
they are *pinned* (page-locked) CPU tensors: every CGS2 pass pulls the
older subspace blocks back across PCIe, and only pinned memory copies
asynchronously at full rate. Copies go on PyTorch's current stream, so a
later read of the same block is ordered after its write.

`make_backend("safs")` raises: the SAFS page store is still to port.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.tiered import IOStats


class RamBackend:
    """Host-memory slow tier, byte-accounted. It pins its buffers exactly
    when the store it serves lives on a CUDA device."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.pin_memory = torch.device(device).type == "cuda"
        self.stats = IOStats()
        self._bufs: Dict[str, torch.Tensor] = {}

    def store(self, data_id: str, t: torch.Tensor) -> None:
        if self.pin_memory:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
        else:
            buf = t.detach().to("cpu", copy=True)
        self._bufs[data_id] = buf
        nbytes = buf.numel() * buf.element_size()
        self.stats.add(host_bytes_written=nbytes, host_writes=1)

    def load(self, data_id: str) -> torch.Tensor:
        t = self._bufs[data_id]
        self.stats.add(host_bytes_read=t.numel() * t.element_size(),
                       host_reads=1)
        return t

    def delete(self, data_id: str) -> None:
        self._bufs.pop(data_id, None)

    def pin(self, data_id: str) -> None:        # no page cache to pin in
        pass

    def unpin(self, data_id: str) -> None:
        pass

    def prefetch(self, data_ids) -> None:       # RAM is already "resident"
        pass

    def close(self) -> None:
        self._bufs.clear()


def make_backend(spec, *, device: torch.device | str = "cpu", **opts):
    """Factory: 'ram' (no opts; pins when `device` is CUDA), or pass
    through an already constructed backend. 'safs' is not ported yet."""
    if not isinstance(spec, str):
        return spec
    if spec == "ram":
        return RamBackend(device, **opts)
    if spec == "safs":
        raise NotImplementedError(
            "the SAFS page store is not ported yet: ROADMAP.md queue 1 "
            "item 3 (SAFS tier under the port)")
    raise ValueError(f"unknown storage backend {spec!r}")
