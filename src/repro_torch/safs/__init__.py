"""Slow-tier storage backends. Only the RAM backend is ported; the SAFS
page store is ROADMAP queue 1 item 3."""
from repro_torch.safs.backend import RamBackend, make_backend

__all__ = ["RamBackend", "make_backend"]
