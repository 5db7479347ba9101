"""Ranks, groups and collectives of the sharded layer on `torch.distributed`.

The port's analogue of the reference's jax device mesh (the reference has
no module of its own for it: `jax.make_mesh` and `shard_map` play its
part). A `Mesh` lays a (pod, data, model) grid over the ranks of one
`torch.distributed` world in jax's order: rank g·M + m is row group g
(g = pod·D + data) and column group m, so rank r owns vertex shard r
(`layout`). It holds the sub-groups the SpMM and the solver step reduce
over and moves tensors between them:

  all_gather      tiled along dim 0 (or `dim`) over the row axes (the
                  panel's column working set) or any other axis set;
  reduce_scatter  sum, tiled along dim 0 (or `dim`), over the model axis
                  or any other;
  all_reduce      sum or max over every axis, the pod axis, or every axis
                  but pod;
  scatter/gather  rank 0 (the controller) to and from every rank's shard;
  broadcast       rank 0's command header to the workers.

Each call adds to `Mesh.bytes` under its kind the bytes of the collective's
whole tensor as one rank sees it: the gathered output of an all-gather,
the input of a reduce-scatter, the tensor of an all-reduce or broadcast,
the full vector of a scatter or gather. Per SpMM that is n_pad/M·b·4
bytes gathered and n_pad/R·b·4 reduced, the count the reference reads
from its compiled HLO.

Backends are chosen by the caller and printed by `Mesh.describe`; nothing
switches them quietly:

  nccl  CUDA tensors, one card per rank (more ranks than cards raises);
  gloo  CPU tensors as they are (the tests). CUDA tensors are staged
        through pinned host memory around every collective, explicitly,
        and `Mesh.bytes["staged"]` counts the bytes copied each way: the
        many-rank world whose ranks share one card.

A (1, 1, 1) mesh needs no world: on one rank with no backend every
collective is the identity (and still counts its bytes); in a one-rank
world the backend runs them. `spawn` starts a world's ranks as
processes, each with a process-group timeout, so that a rank that fails
or hangs fails the caller instead of hanging it.
"""
from __future__ import annotations

import collections
import datetime
import math
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")
BACKENDS = ("nccl", "gloo")
# the collectives of the sharded program itself (not the controller's
# scatter/gather of whole vectors): what a span's collective_bytes sums
PROGRAM_KINDS = ("all_gather", "reduce_scatter", "all_reduce")

_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor")


def free_port() -> int:
    """A TCP port on localhost that is free now (the OS picks it)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(backend: str, device, rank: int) -> torch.device:
    """The device a rank computes on: with nccl card `rank` (one card per
    rank), with gloo the given device itself (every rank shares it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def check_backend(backend: str, device: torch.device, world_size: int
                  ) -> None:
    """Refuse a backend that cannot move this world's tensors."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("nccl moves CUDA tensors; use gloo for "
                             f"{device.type} tensors")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise RuntimeError(
                f"nccl needs one card per rank: {world_size} ranks, "
                f"{cards} card(s); use gloo to share a card")


def init_world(backend: str, *, rank: int, world_size: int,
               init_method: str | None = None, device=None,
               timeout: float = 600.0) -> torch.device:
    """Join this process to a world as `rank` and return its device. The
    process group's `timeout` bounds every collective, so a peer that
    hangs or dies fails this rank instead of hanging it."""
    dev = rank_device(backend, resolve_device(device), rank)
    check_backend(backend, dev, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://127.0.0.1:{free_port()}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return dev


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def group_lists(pod: int, data: int, model: int) -> Dict[str, list]:
    """The rank lists of every group of each axis set of a (pod, data,
    model) grid, in the order every rank creates them."""
    return {
        "rows": [[g * model + m for g in range(pod * data)]
                 for m in range(model)],
        "model": [[g * model + m for m in range(model)]
                  for g in range(pod * data)],
        "pod": [[(p * data + d) * model + m for p in range(pod)]
                for d in range(data) for m in range(model)],
        "nonpod": [[p * data * model + j for j in range(data * model)]
                   for p in range(pod)],
        "data": [[(p * data + d) * model + m for d in range(data)]
                 for p in range(pod) for m in range(model)],
    }


class _Grid:
    """One rank's view of a (pod, data, model) grid: its coordinates, the
    ranks of each of its groups, and the counts of its collectives. Shared
    by `Mesh` (a world of processes) and `DryMesh` (a stand-in with no
    process group), so that both count alike.

    `bytes` adds, by kind, the bytes of each collective's whole tensor as
    one rank sees it (the module docstring's convention); `calls` adds,
    by (kind, axis set), [number of calls, those bytes], and
    `group_ranks(axis)` names the ranks of that call's group."""

    axis_names = AXES

    def __init__(self, shape: Sequence[int], rank: int):
        if len(shape) != 3 or min(shape) < 1:
            raise ValueError(f"mesh shape is (pod, data, model), got "
                             f"{tuple(shape)}")
        self.shape: Dict[str, int] = dict(zip(AXES, map(int, shape)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} of a {self.size}-rank mesh")
        self.rank = rank
        pod, data, model = (self.shape[a] for a in AXES)
        self.r_groups, self.m_groups = pod * data, model
        self.g, self.m = divmod(self.rank, model)
        self.pod = self.g // data
        # this rank's index on each axis (rank = (pod·D + data)·M + model)
        self.coords: Dict[str, int] = {"pod": self.pod,
                                       "data": self.g % data,
                                       "model": self.m}
        self._lists = group_lists(pod, data, model)
        self._members: Dict[str, list] = {
            axis: next(r for r in lists if self.rank in r)
            for axis, lists in self._lists.items()}
        self._members["all"] = list(range(self.size))
        self.bytes: Dict[str, int] = collections.Counter()
        self.calls: Dict[tuple, list] = {}

    def group_ranks(self, axis: str) -> list:
        """The ranks of this rank's group over `axis`, in group order."""
        return self._members[axis]

    def reset_counters(self) -> None:
        self.bytes.clear()
        self.calls.clear()

    def program_bytes(self) -> int:
        """Bytes of the sharded program's collectives so far."""
        return sum(self.bytes[k] for k in PROGRAM_KINDS)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.bytes[kind] += t.numel() * t.element_size()

    def _collective(self, kind: str, axis: str, nbytes: int) -> None:
        """Count one collective of `nbytes` over `axis`'s group."""
        self.bytes[kind] += nbytes
        entry = self.calls.setdefault((kind, axis), [0, 0])
        entry[0] += 1
        entry[1] += nbytes

    @staticmethod
    def _nbytes(shape, dtype) -> int:
        return math.prod(shape) * dtype.itemsize

    @staticmethod
    def _gathered(shape, n: int) -> tuple:
        return (shape[0] * n,) + tuple(shape[1:])


class DryMesh(_Grid):
    """Rank `rank` of a mesh with no world behind it: every collective
    returns a meta tensor of the shape the real call returns (the input
    itself where `Mesh` returns it) and is counted as `Mesh` counts it.
    `mesh` is a `launch.mesh.MeshShape` (a missing axis has size 1) or a
    (pod, data, model) tuple. The dry run (`launch.dryrun`) traces the
    port's sharded programs on it."""

    backend = None

    def __init__(self, mesh, rank: int = 0):
        from repro_torch.launch.mesh import MeshShape, rank_grid
        super().__init__(rank_grid(mesh) if isinstance(mesh, MeshShape)
                         else tuple(mesh), rank)
        self.device = torch.device("meta")

    @staticmethod
    def _meta(shape, dtype) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    # each collective copies and lays out as `Mesh`'s does, so that a
    # trace sees the same tensors
    def all_gather(self, x: torch.Tensor, axis: str = "rows",
                   dim: int = 0) -> torch.Tensor:
        if dim:
            return self.all_gather(x.movedim(dim, 0), axis).movedim(0, dim)
        n = len(self._members[axis])
        x = x.contiguous()
        out = self._gathered(x.shape, n)
        self._collective("all_gather", axis, self._nbytes(out, x.dtype))
        return x if n == 1 else self._meta(out, x.dtype)

    def reduce_scatter(self, x: torch.Tensor, axis: str = "model",
                       dim: int = 0) -> torch.Tensor:
        if dim:
            return self.reduce_scatter(x.movedim(dim, 0), axis).movedim(
                0, dim)
        n = len(self._members[axis])
        x = x.contiguous()
        self._collective("reduce_scatter", axis,
                         self._nbytes(x.shape, x.dtype))
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {n} "
                             "ranks")
        return self._meta((x.shape[0] // n,) + tuple(x.shape[1:]), x.dtype)

    def all_reduce(self, x: torch.Tensor, axis: str = "all",
                   op: str = "sum") -> torch.Tensor:
        if op not in ("sum", "max"):
            raise KeyError(op)
        self._collective("all_reduce", axis, self._nbytes(x.shape, x.dtype))
        return self._meta(x.shape, x.dtype)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        self._collective("broadcast", "all", self._nbytes(x.shape, x.dtype))
        return x

    def scatter(self, full, shard_shape, dtype=torch.float32) -> torch.Tensor:
        shard_shape = tuple(shard_shape)
        self._collective("scatter", "all",
                         self._nbytes(shard_shape, dtype) * self.size)
        return self._meta(shard_shape, dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor | None:
        self._collective("gather", "all",
                         self._nbytes(x.shape, x.dtype) * self.size)
        if self.rank:
            return None
        return self._meta(self._gathered(x.shape, self.size), x.dtype)


class Mesh(_Grid):
    """A (pod, data, model) grid over the ranks of the current world.

    shape: (pod, data, model); its product must be the world size, or 1
    when no world is initialized. `device` is where this rank computes
    (`resolve_device`: the CUDA card unless `device="cpu"`).
    """

    def __init__(self, shape: Sequence[int] = (1, 1, 1), *, device=None):
        if len(shape) != 3 or min(shape) < 1:
            raise ValueError(f"mesh shape is (pod, data, model), got "
                             f"{tuple(shape)}")
        size = math.prod(shape)
        if dist.is_initialized():
            self.backend: Optional[str] = dist.get_backend()
            rank, world = dist.get_rank(), dist.get_world_size()
            if world != size:
                raise ValueError(f"mesh {tuple(shape)} needs {size} "
                                 f"ranks, the world has {world}")
        elif size == 1:
            self.backend, rank = None, 0
        else:
            raise RuntimeError(f"a mesh of {size} ranks needs a "
                               "torch.distributed world: start it with "
                               "comm.spawn or comm.init_world")
        super().__init__(shape, rank)
        self.device = resolve_device(device)
        if self.backend is not None:
            check_backend(self.backend, self.device, self.size)
        # every rank creates every group, in one order (torch.distributed
        # requires it); a group of one rank other than a one-rank world
        # needs no communicator (in a one-rank world the backend still
        # runs every collective)
        self._groups: Dict[str, object] = {}
        for axis, lists in self._lists.items():
            for ranks in lists:
                if len(ranks) == self.size and self.backend is not None:
                    grp = dist.group.WORLD
                elif len(ranks) == 1:
                    grp = None
                else:
                    grp = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = (grp, len(ranks))
        self._groups["all"] = (None if self.backend is None
                               else dist.group.WORLD, self.size)

    # ------------------------------------------------------------ helpers
    def describe(self) -> str:
        return (f"mesh pod={self.shape['pod']} data={self.shape['data']} "
                f"model={self.shape['model']} ({self.size} rank(s), backend "
                f"{self.backend or 'none: one rank, no collective'}, "
                f"{self.device})")

    def _staging(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Pinned host copy of a CUDA tensor, for gloo."""
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self._count("staged", t)
        return h

    def _to_device(self, h: torch.Tensor) -> torch.Tensor:
        self._count("staged", h)
        return h.to(self.device)

    @staticmethod
    def _wire(t: torch.Tensor) -> torch.Tensor:
        # gathers and scatters move bytes: bf16 travels as 16-bit words of
        # a type every backend takes (gloo refuses int16)
        return t.view(torch.float16) if t.dtype == torch.bfloat16 else t

    # -------------------------------------------------------- collectives
    def all_gather(self, x: torch.Tensor, axis: str = "rows",
                   dim: int = 0) -> torch.Tensor:
        """Concatenate every member's x along `dim`, in group rank order."""
        if dim:
            return self.all_gather(x.movedim(dim, 0), axis).movedim(0, dim)
        grp, n = self._groups[axis]
        x = x.contiguous()
        out_shape = self._gathered(x.shape, n)
        self._collective("all_gather", axis, self._nbytes(out_shape,
                                                          x.dtype))
        if grp is None:
            return x
        stage = self._staging(x)
        src = self._to_host(x) if stage else x
        out = torch.empty(out_shape, dtype=x.dtype, device=src.device,
                          pin_memory=stage)
        _all_gather(self._wire(out), self._wire(src), group=grp)
        return self._to_device(out) if stage else out

    def reduce_scatter(self, x: torch.Tensor, axis: str = "model",
                       dim: int = 0) -> torch.Tensor:
        """Sum every member's x and keep this member's tile along `dim`."""
        if dim:
            return self.reduce_scatter(x.movedim(dim, 0), axis).movedim(
                0, dim)
        grp, n = self._groups[axis]
        x = x.contiguous()
        self._collective("reduce_scatter", axis,
                         self._nbytes(x.shape, x.dtype))
        if grp is None:
            return x
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {n} "
                             "ranks")
        stage = self._staging(x)
        src = self._to_host(x) if stage else x
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=src.device, pin_memory=stage)
        _reduce_scatter(out, src, op=dist.ReduceOp.SUM, group=grp)
        return self._to_device(out) if stage else out

    def all_reduce(self, x: torch.Tensor, axis: str = "all",
                   op: str = "sum") -> torch.Tensor:
        """Sum (or max) of every member's x; a new tensor, x untouched."""
        grp, n = self._groups[axis]
        self._collective("all_reduce", axis, self._nbytes(x.shape, x.dtype))
        out = x.clone(memory_format=torch.contiguous_format)
        if grp is None:
            return out
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self._staging(out):
            h = self._to_host(out)
            dist.all_reduce(h, op=red, group=grp)
            return self._to_device(h)
        dist.all_reduce(out, op=red, group=grp)
        return out

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's x on every rank (x is overwritten on the others)."""
        self._collective("broadcast", "all", self._nbytes(x.shape, x.dtype))
        if self.backend is None:
            return x
        if self._staging(x):
            h = self._to_host(x)
            dist.broadcast(h, src=0)
            x.copy_(self._to_device(h))
            return x
        dist.broadcast(x, src=0)
        return x

    def scatter(self, full: torch.Tensor | None, shard_shape,
                dtype=torch.float32) -> torch.Tensor:
        """Rank 0's (size·s, ...) tensor cut into `size` dim-0 tiles, tile
        r to rank r. Only rank 0 passes `full`; every rank gets its
        (shard_shape) tile on its device."""
        shard_shape = tuple(shard_shape)
        self._collective("scatter", "all",
                         self._nbytes(shard_shape, dtype) * self.size)
        if self.backend is None:
            return full.reshape(shard_shape).to(self.device, dtype)
        tiles = None
        stage = self.backend == "gloo" and self.device.type == "cuda"
        if self.rank == 0:
            full = full.to(self.device, dtype).contiguous().reshape(
                (self.size,) + shard_shape)
            if stage:
                full = self._to_host(full)
            tiles = [self._wire(t) for t in full.unbind(0)]
        out = torch.empty(shard_shape, dtype=dtype,
                          device="cpu" if stage else self.device,
                          pin_memory=stage)
        dist.scatter(self._wire(out), tiles, src=0)
        return self._to_device(out) if stage else out

    def gather(self, x: torch.Tensor) -> torch.Tensor | None:
        """Every rank's x concatenated along dim 0 on rank 0 (None on the
        others)."""
        x = x.contiguous()
        self._collective("gather", "all",
                         self._nbytes(x.shape, x.dtype) * self.size)
        if self.backend is None:
            return x
        stage = self._staging(x)
        src = self._to_host(x) if stage else x
        tiles = None
        if self.rank == 0:
            tiles = [torch.empty_like(src) for _ in range(self.size)]
        dist.gather(self._wire(src), [self._wire(t) for t in tiles]
                    if tiles is not None else None, dst=0)
        if tiles is None:
            return None
        out = torch.cat(tiles)
        return self._to_device(out) if stage else out


# ---------------------------------------------------------------- spawn
def run_calls(mesh: Mesh, calls: Sequence[tuple]) -> List[object]:
    """Several programs in one world, in order: each call is (shape, fn,
    args, kwargs), run as fn(mesh of `shape`, *args, **kwargs) on every
    rank (every rank builds each mesh, in one order). A `spawn` rank
    function: starting a world once costs more than most programs. The
    results come back with every tensor as a numpy array (a tensor sent
    between processes is shared through a handle that dies with its
    rank)."""
    from repro_torch.tree import tree_map
    out = []
    for shape, fn, args, kwargs in calls:
        m = (mesh if tuple(shape) == tuple(mesh.shape.values())
             else Mesh(shape, device=mesh.device))
        out.append(tree_map(lambda x: x.detach().cpu().numpy()
                            if isinstance(x, torch.Tensor) else x,
                            fn(m, *args, **kwargs)))
    return out


def _rank_main(rank: int, shape, backend: str, device: str,
               init_method: str, timeout: float, fn, args, results) -> None:
    """One rank of `spawn`: join the world, build the mesh, run fn."""
    try:
        size = math.prod(shape)
        dev = init_world(backend, rank=rank, world_size=size,
                         init_method=init_method, device=device,
                         timeout=timeout)
        if dev.type == "cpu":   # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        out = fn(Mesh(shape, device=dev), *args)
        results.put((rank, "ok", out))
        # no rank tears the group down while a peer still uses it (a rank
        # that finishes first would otherwise break a peer's connection)
        dist.barrier()
    except BaseException:
        # when it failed, on the host's monotonic clock (one for all of its
        # processes): `spawn` reports the failure that came first
        results.put((rank, "error", (time.monotonic(),
                                     traceback.format_exc())))
    finally:
        close_world()


def _first_failure(rank: int, payload, results, procs, done) -> str:
    """The report of the rank that failed first. One rank's failure makes
    its peers fail (a rank that raises closes the group under a peer in a
    collective), and their reports may reach the queue in either order;
    so the reports that arrive within 5 s, or until every other rank has
    reported or exited, are ordered by the time each rank failed."""
    failures = {rank: payload}
    end = time.monotonic() + 5.0
    while True:
        try:
            r, status, report = results.get(timeout=0.2)
        except queue.Empty:
            waiting = [i for i, proc in enumerate(procs)
                       if i not in failures and i not in done
                       and proc.exitcode is None]
            if not waiting or time.monotonic() >= end:
                break
            continue
        if status == "error":
            failures[r] = report
    first = min(failures, key=lambda r: (failures[r][0], r))
    later = sorted(set(failures) - {first})
    return (f"spawn: rank {first} failed:\n{failures[first][1]}"
            + (f"\nthen ranks {later} failed" if later else ""))


def spawn(fn: Callable, shape: Sequence[int], *, backend: str, device=None,
          args: tuple = (), timeout: float = 600.0,
          init_method: str | None = None) -> List[object]:
    """Run fn(mesh, *args) on every rank of a new world of prod(shape)
    processes and return the ranks' results in rank order.

    fn must be importable by name (a function of a module, not of a test
    file or a closure): the ranks are started with multiprocessing's
    "spawn". Rank 0 is the controller by convention (`DistOperator.drive`).
    `device` is the CUDA card unless "cpu" (and raises without a card);
    `backend` is "nccl" (a card per rank) or "gloo". Every collective and
    the whole run are bounded by `timeout` seconds: a rank that raises,
    dies or hangs makes spawn stop every rank and raise. The rendezvous is
    `init_method`, by default a free TCP port on localhost.
    """
    size = math.prod(shape)
    dev = resolve_device(device)
    check_backend(backend, rank_device(backend, dev, 0), size)
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, tuple(shape), backend, str(dev), init_method, timeout, fn,
        args, results)) for rank in range(size)]
    for p in procs:
        p.start()
    out: Dict[int, object] = {}
    deadline = time.monotonic() + timeout
    ok = False
    try:
        while len(out) < size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(size)) - set(out))
                raise TimeoutError(f"spawn: ranks {missing} did not finish "
                                   f"in {timeout:.0f} s")
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} exited with "
                                       f"code {procs[dead[0]].exitcode} "
                                       "without a result")
                continue
            if status == "error":
                raise RuntimeError(_first_failure(rank, payload, results,
                                                  procs, out))
            out[rank] = payload
        ok = True
    finally:
        # after a failure the other ranks may wait in a collective: stop
        # them now rather than after their process-group timeout
        for p in procs:
            p.join(timeout=30 if ok else 0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [out[r] for r in range(size)]
