"""The system under test: the port's packed image, operator and `solve`.

Everything the timed window drives is the port's: `graphs.pack_tiles`,
`core.operator.GraphOperator`, `core.tiered.TieredStore` (RAM backend:
the subspace in pinned host memory, the newest block pinned on the card)
and `core.solver.solve`. A configuration that states a deployment this
does not perform (a streamed image, another store backend) is refused. The harness hands it the generated COO arrays
and the start blocks, and reads back what each solve returns.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from eigbench.bounds.roofline import ImageShape


@dataclasses.dataclass
class Answer:
    """What one solve returned, with its wall seconds."""
    index: int
    wall: float
    values: np.ndarray
    vectors: torch.Tensor        # on the host, float32
    converged: bool
    n_ops: int
    pass_bytes: int
    copy_s: float = 0.0          # the vectors' copy to the host, untimed


class TimedOperator:
    """A `GraphOperator` seen through CUDA events: each `matmat` call is
    bracketed by two events on the current stream (read once the window
    has closed). Only the traced run puts it in the operator's place."""

    def __init__(self, op, tag: str):
        self._op = op
        self.tag = tag
        self.n = op.n
        self.device = op.device
        self.symmetric = op.symmetric
        self.calls: list = []           # (solve index, k, start, end)
        self.solve_index = -1

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function("eigbench.matmat"):
            start.record()
            y = self._op.matmat(x)
            end.record()
        self.calls.append((self.solve_index, int(x.shape[1]), start, end))
        return y

    def timings(self) -> list:
        """[(solve index, k, ms)] of every call; synchronizes."""
        torch.cuda.synchronize()
        return [(i, k, s.elapsed_time(e)) for i, k, s, e in self.calls]


_IMAGE_KEYS = {"block_shape", "min_block_nnz", "dtype", "resident"}
_SOLVER_KEYS = {"method", "which", "tol", "max_iters", "options"}


def check_deployment(config: dict) -> None:
    """Refuse a configuration that states what `System` does not perform:
    a streamed image, a store backend other than RAM, unknown keys."""
    img, store, solver = config["image"], config["store"], config["solver"]
    unknown = (set(img) - _IMAGE_KEYS) | (set(store) - {"backend"}) | (
        set(solver) - _SOLVER_KEYS)
    if unknown:
        raise ValueError(f"configuration {config['name']}: keys "
                         f"{sorted(unknown)} are not implemented by the "
                         f"harness")
    if img["resident"] is not True:
        raise ValueError(f"configuration {config['name']}: only a resident "
                         f"image is implemented (image.resident true)")
    if store["backend"] != "ram":
        raise ValueError(f"configuration {config['name']}: only the RAM "
                         f"store backend is implemented")


class System:
    """The program set up for one configuration and traffic mix."""

    def __init__(self, config: dict, traffic: dict, graph, device):
        from repro_torch.core import GraphOperator
        from repro_torch.graphs import pack_tiles
        check_deployment(config)
        self.config, self.traffic = config, traffic
        self.kind = config["kind"]
        self.device = torch.device(device)
        self.n = graph.n
        img = config["image"]
        dtype = img["dtype"]
        pack = dict(block_shape=tuple(img["block_shape"]),
                    min_block_nnz=int(img["min_block_nnz"]))
        parts = [("A", graph.rows, graph.cols)]
        if self.kind == "svd":
            parts.append(("At", graph.cols, graph.rows))
        self.images: dict = {}
        self.ops: dict = {}
        for tag, r, c in parts:
            tm = pack_tiles(self.n, self.n, r, c, graph.vals, **pack)
            shape = ImageShape.of(tm)
            op = GraphOperator(tm, symmetric=self.kind == "eig",
                               device=self.device)
            del tm
            gc.collect()
            if dtype != "float32":
                op = op.astype(getattr(torch, dtype))
                shape = dataclasses.replace(
                    shape, block_itemsize=torch.finfo(
                        getattr(torch, dtype)).bits // 8)
            self.images[tag] = shape
            self.ops[tag] = op
        self.timed: dict = {}

    def time_matmats(self) -> None:
        """Put a `TimedOperator` in place of each operator."""
        self.timed = {tag: TimedOperator(op, tag)
                      for tag, op in self.ops.items()}

    def set_solve_index(self, index: int) -> None:
        for t in self.timed.values():
            t.solve_index = index

    def solve(self, x0: torch.Tensor, index: int, wall_clock) -> Answer:
        """One solve from start block x0 on a fresh RAM-tier store, timed
        by `wall_clock(fn)` -> (result, seconds)."""
        from repro_torch.core import TieredStore, solve
        ops = self.timed or self.ops
        t, s = self.traffic, self.config["solver"]
        store = TieredStore(backend=self.config["store"]["backend"],
                            device=self.device)
        self.set_solve_index(index)
        kw = dict(block_size=int(t["block_size"]),
                  num_blocks=int(t["num_blocks"]), tol=float(s["tol"]),
                  max_iters=int(s["max_iters"]), store=store, x0=x0,
                  **s.get("options", {}))
        if self.kind == "eig":
            res, wall = wall_clock(lambda: solve(
                ops["A"], int(t["nev"]), method=s["method"],
                which=s["which"], **kw))
        else:
            res, wall = wall_clock(lambda: solve(
                ops["A"], int(t["nev"]), method="svd", at_op=ops["At"],
                **kw))
        io = res.io_stats or {}
        t_copy = time.perf_counter()
        vectors = res.eigenvectors.detach().float().cpu()
        return Answer(index=index, wall=wall,
                      values=np.asarray(res.eigenvalues, np.float64),
                      vectors=vectors, converged=bool(res.converged),
                      n_ops=int(res.n_ops),
                      pass_bytes=int(io.get("pass_bytes_read", 0)),
                      copy_s=time.perf_counter() - t_copy)

    def close(self) -> None:
        """Free the program's state; the answers' host copies stay."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ops.clear()
        self.timed = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
