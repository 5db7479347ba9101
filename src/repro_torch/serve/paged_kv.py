"""Paged KV cache with tier spill — the paper's memory-tiering discipline
applied to serving (port of `repro.serve.paged_kv`).

Long-context serving has the same shape as the paper's problem: a large,
append-mostly state (KV pages ≙ the subspace), a small hot working set
(recent pages ≙ the most-recent block), and a slow big tier to spill to
(host DRAM ≙ SSD). This module implements:

  * fixed-size KV pages with a block table per sequence (vLLM-style),
  * LRU spill of cold pages to the TieredStore host tier with byte-exact
    accounting (reads ≪ writes inverted here: decode *writes* one page
    slot per token but *reads* the whole context — same read-dominated
    profile as Table 3),
  * gather-based attention over the page table (plain PyTorch: einsum and
    softmax, as the reference's is plain JAX; no kernel runs here).

Pages are tensors on the store's device. An append writes the token into
a copy of its page and puts the copy back, never into a tensor the store
holds, so the store's `IOStats` count what the reference's functional
update counts.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.tiered import TieredStore


@dataclasses.dataclass
class PagedConfig:
    page_size: int = 128          # tokens per page
    n_kv_heads: int = 2
    head_dim: int = 16
    hot_pages: int = 8            # device-tier page budget per sequence
    dtype: str = "float32"        # by name: "float32", "bfloat16", ...


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class PagedKVCache:
    """Per-sequence paged KV storage over a TieredStore.

    `session_id` routes every page name through `store.namespace(...)`, so
    a KV-spill workload coexists with solver sessions on ONE shared store:
    its pages live under its own key prefix, its device bytes count against
    its own arbiter allotment, and session end (`close()`) reclaims them
    without touching the solvers' blocks. Omitted (the default), the cache
    uses the store directly — the standalone demo path is byte-identical
    to before namespaces existed.

    With no store the cache builds `TieredStore(device=device)`: the CUDA
    card unless `device="cpu"`, raising when there is no card.
    """

    def __init__(self, cfg: PagedConfig, store: TieredStore | None = None,
                 *, session_id: str | None = None, device=None):
        self.cfg = cfg
        self._dtype = _torch_dtype(cfg.dtype)
        if store is None:
            store = TieredStore(device=device)
        self.session_id = session_id
        if session_id is not None:
            ns = getattr(store, "namespace", None)
            if ns is None:
                raise TypeError(f"store {type(store).__name__!r} has no "
                                "namespace() — cannot scope session "
                                f"{session_id!r}")
            store = ns(session_id)
        self.store = store
        self._tables: dict[int, list[str]] = {}   # seq id -> page names
        self._fill: dict[int, int] = {}           # tokens written

    def close(self) -> None:
        """Retire a namespaced cache (drops its pages from the shared
        store); a no-op for the un-namespaced standalone form."""
        if self.session_id is not None:
            self.store.close()
        self._tables.clear()
        self._fill.clear()

    def _page_shape(self):
        c = self.cfg
        return (c.page_size, c.n_kv_heads, c.head_dim)

    def _as_token(self, x) -> torch.Tensor:
        """One token's (K, hd) k or v, numpy or tensor, on the page's
        device (its type is cast by the slot write, as JAX's `.set`
        casts)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.store.device)

    def _new_page(self, seq: int) -> str:
        name = f"kv/{seq}/p{len(self._tables[seq])}"
        z = torch.zeros((2,) + self._page_shape(), dtype=self._dtype,
                        device=self.store.device)
        self.store.put(name, z)
        self._tables[seq].append(name)
        # spill: keep only hot_pages newest on device
        table = self._tables[seq]
        for old in table[:-self.cfg.hot_pages]:
            if self.store.tier_of(old) != "host":
                self.store.demote(old)
        return name

    def start(self, seq: int) -> None:
        self._tables[seq] = []
        self._fill[seq] = 0

    def append(self, seq: int, k, v) -> None:
        """Append one token's (K,hd) k/v."""
        c = self.cfg
        pos = self._fill[seq]
        if pos % c.page_size == 0:
            self._new_page(seq)
        name = self._tables[seq][-1]
        page = self.store.get(name).clone()
        slot = pos % c.page_size
        page[0, slot] = self._as_token(k)
        page[1, slot] = self._as_token(v)
        self.store.put(name, page)  # rewrite hot page (device tier)
        self._fill[seq] = pos + 1

    def length(self, seq: int) -> int:
        return self._fill[seq]

    def gather(self, seq: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Materialize (k, v) for attention: (S, K, hd) each. Cold pages
        are read from the host tier (counted)."""
        pages = [self.store.get(n) for n in self._tables[seq]]
        if not pages:
            shape = (0,) + self._page_shape()
            z = torch.zeros(shape, dtype=self._dtype,
                            device=self.store.device)
            return z, z
        stacked = torch.cat(pages, dim=1)  # (2, S_pages, K, hd)
        s = self._fill[seq]
        return stacked[0, :s], stacked[1, :s]

    def attend(self, seq: int, q) -> torch.Tensor:
        """Single-token attention over the paged context.
        q (H, hd) with GQA groups folded → returns (H, hd). Runs in the
        promoted type of q and the pages (a float32 query over bf16 pages
        computes in float32, as JAX promotes)."""
        k, v = self.gather(seq)
        q = self._as_token(q)
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        kh = self.cfg.n_kv_heads
        h = q.shape[0]
        g = h // kh
        qg = q.reshape(kh, g, -1)
        s = torch.einsum("kgd,skd->kgs", qg, k) / math.sqrt(q.shape[-1])
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("kgs,skd->kgd", w, v)
        return out.reshape(h, -1)
