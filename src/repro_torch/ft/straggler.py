"""Straggler detection + mitigation decisions (a copy of
`repro.ft.straggler`).

At pod scale the common straggler sources are a slow host NIC, a thermally
throttled chip, or skewed work (for the eigensolver: nnz imbalance between
edge panels). The tracker keeps an EWMA of step times per participant and
flags sustained outliers; mitigation is a *decision* the launcher acts on:

  * "rebalance"  — repack edge panels / re-LPT the tile rows (eigensolver)
                   or rebalance data shards (LM training) at the next
                   restart/checkpoint boundary;
  * "evict"      — drop the participant and trigger elastic re-shard
                   (ckpt.restore onto the smaller mesh).

Detection is trace-driven and unit-testable without hardware.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class StragglerDecision:
    participant: int
    action: str          # "none" | "rebalance" | "evict"
    slowdown: float      # participant_time / median_time


class StragglerTracker:
    def __init__(self, *, ewma: float = 0.3, rebalance_at: float = 1.3,
                 evict_at: float = 2.5, min_steps: int = 5):
        self.ewma = ewma
        self.rebalance_at = rebalance_at
        self.evict_at = evict_at
        self.min_steps = min_steps
        self._t = defaultdict(float)   # participant -> ewma step time
        self._n = defaultdict(int)

    def record(self, participant: int, step_time: float) -> None:
        a = self.ewma
        if self._n[participant] == 0:
            self._t[participant] = step_time
        else:
            self._t[participant] = (1 - a) * self._t[participant] + a * step_time
        self._n[participant] += 1

    def decisions(self) -> list[StragglerDecision]:
        ready = {p: t for p, t in self._t.items()
                 if self._n[p] >= self.min_steps}
        if len(ready) < 2:
            return []
        times = sorted(ready.values())
        median = times[len(times) // 2]
        out = []
        for p, t in ready.items():
            slow = t / max(median, 1e-12)
            if slow >= self.evict_at:
                out.append(StragglerDecision(p, "evict", slow))
            elif slow >= self.rebalance_at:
                out.append(StragglerDecision(p, "rebalance", slow))
        return out
