"""BudgetArbiter — one global device/host budget split across live sessions
(a copy of `repro.serve.arbiter`: pure Python over the store's
`set_namespace_budget`).

The paper runs FlashEigen against SAFS's *shared* page cache (§3.4): many
workloads, one SSD array, one cache budget. The serving layer reproduces
that contract for the device tier too — instead of every script hard-coding
its own `TieredStore(device_budget_bytes=...)` global, the arbiter owns ONE
global budget and splits it across admitted sessions by priority:

    share(s) = device_budget · weight(s) / Σ weight,   weight = priority + 1

recomputed on every admit/release, floored at `min_share` so a low-priority
session can always make progress (a share below one subspace block would
thrash). Shares are pushed into the store as per-namespace budgets
(`TieredStore.set_namespace_budget`) — shrinking a live session's allotment
demotes its own LRU entries immediately, so an admit takes effect without
waiting for the incumbent's next put.

The host-tier budget is advisory (the SSD/page-file tier is effectively
unbounded in this emulation); it is tracked and reported so the serve
report can flag oversubscription, but not enforced by eviction.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional


class BudgetArbiter:
    """Priority-proportional splitter of one device budget over sessions."""

    def __init__(self, store, *, device_budget: Optional[int] = None,
                 host_budget: Optional[int] = None,
                 min_share: int = 1 << 20):
        self.store = store
        self.device_budget = int(device_budget if device_budget is not None
                                 else store.device_budget)
        self.host_budget = host_budget
        self.min_share = int(min_share)
        self._live: Dict[str, int] = {}     # session_id -> priority
        self._shares: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.admits = 0
        self.releases = 0

    @staticmethod
    def _weight(priority: int) -> int:
        return max(1, int(priority) + 1)

    def admit(self, session_id: str, priority: int = 0) -> int:
        """Admit a session and recompute every live share; returns the new
        session's device allotment in bytes."""
        with self._lock:
            self._live[session_id] = int(priority)
            self.admits += 1
            self._recompute()
            return self._shares[session_id]

    def release(self, session_id: str) -> None:
        """Drop a finished/suspended session and redistribute its share."""
        with self._lock:
            if session_id not in self._live:
                return
            del self._live[session_id]
            self._shares.pop(session_id, None)
            self.releases += 1
            self.store.set_namespace_budget(session_id, None)
            self._recompute()

    def allotment(self, session_id: str) -> Optional[int]:
        with self._lock:
            return self._shares.get(session_id)

    def _recompute(self) -> None:
        # caller holds the lock
        total_w = sum(self._weight(p) for p in self._live.values())
        for sid, prio in self._live.items():
            share = self.device_budget * self._weight(prio) // max(total_w, 1)
            share = max(self.min_share, share)
            self._shares[sid] = share
            self.store.set_namespace_budget(sid, share)

    def stats_dict(self) -> dict:
        with self._lock:
            return {
                "device_budget": self.device_budget,
                "host_budget": self.host_budget,
                "min_share": self.min_share,
                "live_sessions": dict(self._live),
                "shares": dict(self._shares),
                "admits": self.admits,
                "releases": self.releases,
                "oversubscribed": (sum(self._shares.values())
                                   > self.device_budget),
            }
