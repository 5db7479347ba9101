"""File-based coordination: heartbeats + generation-numbered membership
(a copy of `repro.ft.coordinator`).

Stands in for the control-plane (GCS / etcd / Borg) a real 1000-node job
uses. Each participant heartbeats a file; the coordinator computes live
membership; a membership change bumps the *generation*, which invalidates
in-flight collectives and tells every participant to restore from the last
checkpoint with the new mesh (elastic scaling). All logic is local-fs and
unit-testable.
"""
from __future__ import annotations

import json
import os
import time


class Coordinator:
    def __init__(self, root: str, *, timeout: float = 10.0):
        self.root = root
        self.timeout = timeout
        os.makedirs(os.path.join(root, "hb"), exist_ok=True)

    # -- participant side ----------------------------------------------------
    def heartbeat(self, participant: int, *, now: float | None = None) -> None:
        path = os.path.join(self.root, "hb", f"{participant}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"t": now if now is not None else time.time()}, f)
        os.replace(tmp, path)

    # -- coordinator side ----------------------------------------------------
    def live_members(self, *, now: float | None = None) -> list[int]:
        now = now if now is not None else time.time()
        out = []
        hb = os.path.join(self.root, "hb")
        for fn in os.listdir(hb):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(hb, fn)) as f:
                    t = json.load(f)["t"]
                member = int(fn.split(".")[0])
            except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                    OSError):
                # a truncated/corrupt/vanished heartbeat is a DEAD member
                # (a node killed mid-write), not a coordinator crash — the
                # membership change is exactly what generation() must see
                continue
            if now - t <= self.timeout:
                out.append(member)
        return sorted(out)

    def generation(self) -> tuple[int, list[int]]:
        """Current (generation, membership); bumps generation on change."""
        gen_path = os.path.join(self.root, "gen.json")
        members = self.live_members()
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                state = json.load(f)
        else:
            state = {"gen": 0, "members": []}
        if members != state["members"]:
            state = {"gen": state["gen"] + 1, "members": members}
            tmp = gen_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, gen_path)
        return state["gen"], members
