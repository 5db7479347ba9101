"""Dry run on the meta device: trace the port's own sharded programs on
one rank of each production mesh, and record memory, FLOPs, bytes,
collectives and an H100 roofline for every (architecture × input shape ×
mesh) cell the reference's dry run enumerates (port of
`repro.launch.dryrun`).

Usage:
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--jobs 8]
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  python -m repro_torch.launch.dryrun --arch flasheigen --graph page

The reference lowers each cell with `jax.jit` over 512 forced host
devices and reads XLA's analyses. The port has no compiler: a cell runs
the program a rank of the mesh would run (`models.steps`' train, prefill
and decode steps with a `train.sharded.Sharding`, or `dist.dspmm`'s
eigen step) on meta tensors (shapes and types, no storage) and on a
`dist.comm.DryMesh` standing for rank 0 of the mesh, which returns meta
tensors from every collective and counts it as `comm.Mesh` counts it.
So the collectives are those the program really issues, as HLO parsing
counts what XLA emitted. A record holds:

  * FLOPs: every op's by `FlopCounterMode`'s formulas; the hand-written
    kernels take their shape-only path on meta tensors (`kernels.meta`),
    whose formulas count the products each kernel executes;
  * bytes: every op's inputs and outputs (a view moves none), through a
    dispatch mode: a pre-fusion upper bound, as the reference's
    unoptimized-HLO bytes are;
  * memory: arguments exact, from the specs' blocks (parameters,
    moments, this rank's batch rows, cache); temp the peak of the live
    bytes the trace allocated (each output's storage tracked until it is
    freed). The caching allocator is not modelled;
  * collectives: `utils.collective_cost` over the DryMesh's counted
    calls, each priced by the bandwidth of its group's link; the design's
    count beside it (`Sharding.analytic_bytes` for train cells,
    `dspmm.design_bytes` for eigen cells);
  * the roofline: compute, memory and collective seconds with the
    reference's formulas, from the H100 SXM constants below;
  * `trace_s`, the seconds the trace took, where the reference has
    `lower_s` and `compile_s`: nothing is compiled.

Every rank of a row group computes whole layers (the port's sharding
gathers parameters on use and splits storage, not FLOPs), so the traced
FLOPs are one rank's and `useful_ratio` = model FLOPs ÷ (traced FLOPs ×
devices) shows the redundancy over 'model'. The decode cache is held
split over the data axes only; where the reference's `cache_specs` shards
a leaf over 'model', the record's `cache_split` says so.

Results append to a JSONL file; cached (arch, shape, mesh, variant) cells
are skipped, and a cell that fails becomes an `error` record.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.dist import layout
from repro_torch.dist.comm import DryMesh
from repro_torch.dist.dspmm import (CompressedPanel, MetaPanel,
                                    build_eigen_step,
                                    build_eigen_step_compressed,
                                    design_bytes)
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.models import sharding as shd
from repro_torch.models import steps as S
from repro_torch.models import transformer as tf
from repro_torch.models.modules import rope_freqs
from repro_torch.optim import adamw
from repro_torch.train.sharded import Sharding
from repro_torch.tree import flatten_with_paths
from repro_torch.utils.collective_cost import (HLO_KIND, collective_cost,
                                               mesh_calls, wire_bytes)

# NVIDIA H100 SXM5 80 GB, per card, as its data sheet states them (not
# measured by this module)
PEAK_FLOPS = 989e12     # bf16 dense tensor-core peak, FLOP/s
HBM_BW = 3.35e12        # HBM3, bytes/s
NVLINK_BW = 450e9       # NVLink 4 inside an 8-GPU HGX node, a direction
NET_BW = 50e9           # across nodes: one 400 Gb/s NDR port a GPU
NODE_GPUS = 8           # GPUs of one HGX node (consecutive ranks)
LINK_BW = {"nvlink": NVLINK_BW, "network": NET_BW}
DEFAULT_OUT = "results/dryrun_torch.jsonl"


# ---------------------------------------------------------------- helpers
def n_row_devices(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh.axis_names if a != "model")


def microbatch_policy(cfg, shape, mesh) -> int:
    """The reference's rule: the smallest microbatch count whose
    activation + logits footprint fits a ~6 GB per-device budget."""
    rows = n_row_devices(mesh)
    if shape.global_batch % rows:
        return 1
    b_loc = shape.global_batch // rows
    budget = 6e9
    s, d, v, l = shape.seq_len, cfg.d_model, cfg.vocab_size, cfg.n_layers
    for mb in [m for m in (1, 2, 4, 8, 16, 32) if b_loc % m == 0]:
        per = b_loc // mb
        act = l * per * s * d * 2          # saved layer inputs (bf16)
        logits = per * s * v * 4           # f32 CE materialization
        if act + logits <= budget:
            return mb
    return b_loc


# the reference's §Perf variants. The port applies every config field
# but `shard_cache_seq` (its decode cache splits over the data axes only:
# `cache_split`); `compressed` selects the eigen step's 6-byte stream
VARIANTS = {
    "opt-decode": {"moe_decode_regroup": True, "shard_cache_seq": True},
    "opt-prefill": {"prefill_last_only": True,
                    "bf16_residual": True},
    "opt-cache-seq": {"shard_cache_seq": True},
    "opt-moe-regroup": {"moe_decode_regroup": True},
    "opt-eigen": {"compressed": True},          # flasheigen cells only
    "opt-prefill-nofsdp": {"prefill_last_only": True, "bf16_residual": True,
                           "use_fsdp": False},
}


def _cfg_with(arch: str, variant: str | None):
    cfg = configs.get(arch)
    if variant:
        ov = {k: v for k, v in VARIANTS[variant].items()
              if k != "compressed"}
        cfg = dataclasses.replace(cfg, **ov)
    return cfg


def model_flops_of(arch: str, shape_name: str) -> float:
    if arch == "flasheigen":
        g = configs.GRAPHS[shape_name]
        m = g.subspace
        # SpMM + two CGS passes (gram + update) + CholQR² per expansion
        return (2.0 * g.n_edges * g.block_size
                + 8.0 * g.n_vertices * m * g.block_size
                + 8.0 * g.n_vertices * g.block_size * g.block_size)
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch        # decode: 1 token/seq


def accounting_cost(arch: str, shape_name: str,
                    variant: str | None = None) -> dict:
    """The reference's closed form of one eigen step's FLOP and byte
    totals over the whole graph (flasheigen cells only: an LM cell's
    totals come from its trace)."""
    if arch != "flasheigen":
        raise ValueError("accounting_cost: the closed form covers "
                         "flasheigen cells only")
    g = configs.GRAPHS[shape_name]
    n, m, b = g.n_vertices, g.subspace, g.block_size
    e = g.n_edges
    compressed = bool(variant and VARIANTS[variant].get("compressed"))
    flops = 2.0 * e * b + 8.0 * n * (m - b) * b + 8.0 * n * b * b
    edge_b = 6 if compressed else 12         # uint16-packed+bf16 vs raw
    panel_b = 2 * b if compressed else 4 * b  # bf16 vs f32 X gather
    v_b = 2 if compressed else 4              # bf16 vs f32 subspace
    bytes_ = (e * (edge_b + panel_b + 4 * b)  # stream + gather + scatter
              + 4.0 * v_b * n * (m - b)       # 4 reads of V (CGS2)
              + 40.0 * n * b)                 # w/x round trips
    return {"flops_total": flops, "bytes_total": bytes_}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------- trace
class _Trace(TorchDispatchMode):
    """The FLOPs of every op, by the formulas `FlopCounterMode` reads
    (its registry, where `kernels.meta` adds the kernels'); the bytes
    every op reads and writes; and the peak of the bytes the trace holds:
    each output's storage counts from the op that made it until it is
    freed. Storages that exist before the trace (the arguments) are not
    counted. One dispatch mode does all three: `FlopCounterMode` itself
    would add a second, about a quarter more time a trace
    (tests/test_torch_dryrun.py holds the two counts equal).

    Most of a trace's time is the meta kernels of elementwise ops (Python
    reference implementations, ~0.1 ms a call), and a model repeats the
    same op on the same shapes layer after layer. So an op that makes new
    tensors from its inputs (no view, no mutation) runs once for each
    (op, input shapes, strides, types, other arguments); a repeat gets
    new meta tensors of the outputs' shapes, strides and types. With
    `cache=False` every op runs; the counts are the same."""

    def __init__(self, args, cache: bool = True):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._formulas = FlopCounterMode(display=False).flop_registry
        self._held = {}
        self._args = {t.untyped_storage()._cdata for t in tree_leaves(args)
                      if isinstance(t, torch.Tensor)}
        self._cache = {} if cache else None
        self._pure: dict = {}

    def _free(self, key) -> None:
        self.live -= self._held.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held or key in self._args:
            return
        self._held[key] = st.nbytes()
        self.live += self._held[key]
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _is_pure(self, func) -> bool:
        """Whether an op only makes new tensors (an aten op with no view,
        no mutation and no alias among its outputs), by its schema until
        a call shows otherwise."""
        pure = self._pure.get(func)
        if pure is None:
            schema = func._schema
            pure = self._pure[func] = (
                func.namespace == "aten" and not func.is_view
                and not schema.is_mutable
                and all(r.alias_info is None for r in schema.returns))
        return pure

    def _run(self, func, args, kwargs):
        if self._cache is None or not self._is_pure(func):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs.items()))
        except TypeError:            # an argument that does not hash
            return func(*args, **kwargs)
        meta = self._cache.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            ins = {t.untyped_storage()._cdata
                   for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)}
            if not all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                       for t in outs):
                return out
            if any(t.untyped_storage()._cdata in ins for t in outs):
                self._pure[func] = False    # an alias its schema hides
                return out                  # (`_unsafe_view`)
            self._cache[key] = (type(out), [
                (tuple(t.shape), t.stride(), t.dtype) for t in outs])
            return out
        kind, specs = meta
        outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                    device="meta")
                for shape, stride, dtype in specs]
        return outs[0] if kind is torch.Tensor else kind(outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not func.is_view:
            self.bytes += _flat_bytes(args) + _flat_bytes(kwargs.values()) \
                + _flat_bytes(outs)
        for t in outs:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def _key(items) -> tuple:
    """A hashable key of an op's arguments: each meta tensor by its shape,
    strides and type, anything else by its type and value. TypeError for
    a tensor on another device (a CPU scalar takes part in type promotion
    by more than its type) or a value that does not hash."""
    out = []
    for x in items:
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                raise TypeError("not a meta tensor")
            out.append((tuple(x.shape), x.stride(), x.dtype))
        elif isinstance(x, (tuple, list)):
            out.append(_key(x))
        else:
            hash(x)
            out.append((type(x), x))
    return tuple(out)


def _flat_bytes(items) -> int:
    """Bytes of the tensors among an op's arguments (tensors, or lists of
    them, as aten's schemas take them)."""
    n = 0
    for x in items:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            n += _flat_bytes(x)
    return n


def trace(run, args, cache: bool = True) -> dict:
    """Run `run()` (a step over `args`) under the trace; its FLOPs,
    bytes and peak, and the bytes of its outputs."""
    tr = _Trace(args, cache)
    t0 = time.perf_counter()
    with tr:
        out = run()
    trace_s = time.perf_counter() - t0
    seen, out_bytes = set(), 0
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key not in seen and key not in tr._args:
                seen.add(key)
                out_bytes += t.untyped_storage().nbytes()
    return {"flops": float(tr.flops), "bytes": float(tr.bytes),
            "temp": tr.peak, "output": out_bytes, "trace_s": trace_s}


def link_of(ranks) -> str:
    """"nvlink" when a group's ranks lie within one run of NODE_GPUS
    consecutive ranks (one HGX node), else "network"."""
    return ("nvlink" if min(ranks) // NODE_GPUS == max(ranks) // NODE_GPUS
            else "network")


def price_collectives(dry) -> tuple[dict, dict, float]:
    """(collective_cost of the mesh's calls, wire bytes by op kind and
    link, collective seconds: each call's wire bytes over its link)."""
    calls = mesh_calls(dry)
    cost = collective_cost((k, len(r), n, b) for k, _, r, n, b in calls)
    links: dict = {}
    seconds = 0.0
    for kind, _, ranks, _, nbytes in calls:
        hlo = HLO_KIND.get(kind)
        if hlo is None or len(ranks) <= 1:
            continue
        link = link_of(ranks)
        wire = wire_bytes(hlo, nbytes, len(ranks))
        by = links.setdefault(hlo, {})
        by[link] = by.get(link, 0.0) + wire
        seconds += wire / LINK_BW[link]
    return cost, links, seconds


# ---------------------------------------------------------------- cells
def _param_blocks(shards: Sharding):
    return shards.tree([_meta(p.block_shape(s), d) for p, s, d in
                        zip(shards.params, shards.shapes, shards.dtypes)])


def _moment_blocks(shards: Sharding):
    return shards.tree([_meta(o.block_shape(s), torch.float32)
                        for o, s in zip(shards.moments, shards.shapes)])


def _cache_split(cache, cfg, mesh, batch: int, port_batch_ax) -> dict:
    """Where the decode cache lives: the port's split (batch over the
    data axes, when they divide it) beside the reference's specs, whose
    'model' entries the port does not apply."""
    specs = []
    shd._map_specs(specs.append, shd.cache_specs(
        cache, cfg, mesh, batch, shard_seq=cfg.shard_cache_seq))
    names = flatten_with_paths(cache)[0]
    over_model = sorted({n.split("/", 2)[-1] for n, sp in zip(names, specs)
                         if any(e == "model" or (isinstance(e, tuple)
                                                 and "model" in e)
                                for e in sp)})
    return {"port": {"batch": list(port_batch_ax) if port_batch_ax
                     else None},
            "reference": {"model": over_model}}


def lm_program(cfg, shape, mesh, *, rank: int = 0,
               num_microbatches: int | None = None):
    """(run, args, dry mesh, argument bytes, design bytes or None, meta):
    the step of `shape` (a `ShapeConfig`) that rank `rank` of `mesh` (a
    `MeshShape` or a (pod, data, model) tuple) runs, over meta blocks of
    its state. A train step takes `num_microbatches`, by default
    `microbatch_policy`'s."""
    dry = DryMesh(mesh, rank)
    shards = Sharding(cfg, dry)
    params = _param_blocks(shards)
    held = shards.held_bytes()
    meta: dict = {}
    # RoPE's constant table is built once a process (`modules._inv_freq`):
    # build it before the trace, so that no record depends on which cells
    # a process traced before
    rope_freqs(cfg, _meta((1,), torch.float32))
    if shape.kind == "train":
        mb = num_microbatches or microbatch_policy(cfg, shape, dry)
        opt = adamw.AdamWState(step=_meta((), torch.int32),
                               m=_moment_blocks(shards),
                               v=_moment_blocks(shards))
        batch = S.make_batch_specs(cfg, shape.global_batch, shape.seq_len)
        fn = S.build_train_step(cfg, num_microbatches=mb, sharding=shards)
        args = (params, opt, batch)
        arg_bytes = (held["params"] + held["moments"] + 4
                     + _nbytes(shards.local_batch(batch)))
        meta["microbatches"] = mb
        return (lambda: fn(*args)), args, dry, arg_bytes, \
            shards.analytic_bytes(mb), meta

    if shape.kind == "prefill":
        batch = S.make_batch_specs(cfg, shape.global_batch, shape.seq_len)
        batch.pop("targets")
        fn = S.build_prefill_step(cfg, sharding=shards)
        args = (params, batch)
        arg_bytes = held["params"] + _nbytes(shards.local_batch(batch))

        def run():
            with torch.no_grad():
                return fn(*args)
        return run, args, dry, arg_bytes, None, meta

    # decode: one new token against a seq_len-deep cache of this rank's
    # rows (batch split over the data axes when they divide it)
    rows = n_row_devices(dry)
    split = shape.global_batch % rows == 0
    b_loc = shape.global_batch // rows if split else shape.global_batch
    cache = tf.init_cache(cfg, b_loc, shape.seq_len, device="meta")
    token = _meta((b_loc, 1), torch.int32)
    fn = S.build_decode_step(cfg, sharding=shards)
    args = (params, cache, token)
    arg_bytes = held["params"] + _nbytes(cache) + _nbytes(token)
    meta["cache_split"] = _cache_split(
        tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                      device="meta"), cfg, dry, shape.global_batch,
        data_axes(dry) if split else None)

    def run():
        with torch.no_grad():
            return fn(params, cache, token, shape.seq_len - 1)
    return run, args, dry, arg_bytes, None, meta


def lm_cell(arch: str, shape_name: str, mesh, variant: str | None = None,
            rank: int = 0):
    """`lm_program` of one LM cell of the reference's table."""
    return lm_program(_cfg_with(arch, variant), SHAPES[shape_name], mesh,
                      rank=rank)


def eigen_program(n_vertices: int, n_edges: int, *, b: int, nb_v: int,
                  mesh, compressed: bool = False, rank: int = 0):
    """One fused Krylov expansion (`dspmm.build_eigen_step`, or the
    compressed stream's) on rank `rank` of `mesh`, over a meta panel of
    e_loc edges, a meta (nb_v, s, b) stack and a meta x shard; as
    `lm_program`, with the design's count `dspmm.design_bytes`."""
    dry = DryMesh(mesh, rank)
    r_groups, m_groups = dry.r_groups, dry.m_groups
    n_pad = layout.padded_n(n_vertices, r_groups, m_groups)
    s = layout.shard_size(n_pad, r_groups, m_groups)
    e_loc = -(-n_edges // dry.size)
    meta = {"n_pad": n_pad, "e_loc": e_loc, "b": b, "nb_v": nb_v}
    if compressed:
        fn, n_chunks, e_pad = build_eigen_step_compressed(
            dry, n_pad=n_pad, e_loc=e_loc, b=b, nb_v=nb_v)
        panel = CompressedPanel.meta(e_pad, n_chunks, n_pad // r_groups)
        dt = torch.bfloat16
        meta.update(e_pad=e_pad, bytes_per_edge=6)
    else:
        fn = build_eigen_step(dry, n_pad=n_pad, e_loc=e_loc, b=b, nb_v=nb_v)
        panel = MetaPanel(e_loc, n_pad // r_groups)
        dt = torch.float32
        meta["bytes_per_edge"] = 12
    v, x = _meta((nb_v, s, b), dt), _meta((s, b), dt)
    args = (vars(panel), v, x)
    design = design_bytes(n_pad, r_groups, m_groups, b=b,
                          x_bytes=x.element_size(), nb_v=nb_v)
    return (lambda: fn(panel, v, x)), args, dry, _nbytes(args), design, \
        meta


def eigen_cell(graph_name: str, mesh, variant: str | None = None,
               rank: int = 0):
    """The paper's own cells: `eigen_program` at a graph's scale."""
    g = configs.GRAPHS[graph_name]
    return eigen_program(
        g.n_vertices, g.n_edges, b=g.block_size, nb_v=g.num_blocks - 1,
        mesh=mesh, rank=rank,
        compressed=bool(variant and VARIANTS[variant].get("compressed")))


# ---------------------------------------------------------------- analyze
def analyze(run, args, dry, arg_bytes: int, design, model_flops: float
            ) -> dict:
    dry.reset_counters()
    t = trace(run, args)
    counted = {k: v for k, v in dry.bytes.items() if v}
    coll, links, collective_s = price_collectives(dry)
    n_dev = dry.size
    flops_dev, bytes_dev = t["flops"], t["bytes"]
    terms = {"compute_s": flops_dev / PEAK_FLOPS,
             "memory_s": bytes_dev / HBM_BW,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": t["output"],
           "temp_size_in_bytes": t["temp"],
           "alias_size_in_bytes": 0}
    rec = {
        "n_devices": n_dev,
        "trace_s": round(t["trace_s"], 3),
        "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
        "traced_flops_total": flops_dev * n_dev,
        "memory": mem,
        "per_device_bytes_resident": arg_bytes + t["temp"],
        "collective_per_device": coll,
        "collective_links": links,
        "link_bw": LINK_BW,
        "collective_bytes": counted,
        "model_flops": model_flops,
        "useful_ratio": (model_flops / (flops_dev * n_dev)) if flops_dev
        else 0.0,
        **terms,
        "dominant": dominant,
        "step_time_bound_s": max(terms.values()),
        "roofline_fraction": (model_flops / (n_dev * PEAK_FLOPS))
        / max(max(terms.values()), 1e-30),
    }
    if design is not None:
        rec["design_bytes"] = {k: v for k, v in design.items() if v}
        rec["design_match"] = rec["design_bytes"] == counted
    return rec


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str | None = None) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    if arch == "flasheigen":
        run, args, dry, arg_bytes, design, meta = eigen_cell(
            shape_name, mesh, variant)
        meta["accounting"] = accounting_cost(arch, shape_name, variant)
    else:
        run, args, dry, arg_bytes, design, meta = lm_cell(
            arch, shape_name, mesh, variant)
    rec = analyze(run, args, dry, arg_bytes, design,
                  model_flops_of(arch, shape_name))
    rec.update({"arch": arch, "shape": shape_name,
                "variant": variant or "baseline",
                "mesh": mesh_name(multi_pod), **meta})
    return rec


def all_cells(include_eigen: bool = True):
    cells = []
    for arch, cfg in configs.ARCHS.items():
        for shape_name, shape in SHAPES.items():
            ok, _ = shape_applicable(cfg, shape)
            if ok:
                cells.append((arch, shape_name))
    if include_eigen:
        for gname in configs.GRAPHS:
            cells.append(("flasheigen", gname))
    return cells


def _cell_or_error(arch, shape, mp, variant) -> dict:
    try:
        return run_cell(arch, shape, mp, variant)
    except Exception as e:  # record failures: they are port faults
        return {"arch": arch, "shape": shape, "mesh": mesh_name(mp),
                "variant": variant or "baseline",
                "error": f"{type(e).__name__}: {e}"}


def _cached(path: str) -> set:
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("variant", "baseline")))
                except json.JSONDecodeError:
                    pass
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--graph")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default=None, choices=list(VARIANTS))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = _cached(args.out)
    if args.all:
        cells = all_cells()
    elif args.arch == "flasheigen":
        cells = [("flasheigen", args.graph or "twitter")]
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    vname = args.variant or "baseline"
    todo = []
    for arch, shape in cells:
        for mp in meshes:
            if (arch, shape, mesh_name(mp), vname) in done:
                print(f"skip {arch} {shape} {mesh_name(mp)} {vname} "
                      f"(cached)")
            else:
                todo.append((arch, shape, mp, args.variant))

    def write(rec):
        print(f"=== {rec['arch']} {rec['shape']} {rec['mesh']} "
              f"{rec['variant']}", flush=True)
        if "error" in rec:
            print("FAILED:", rec["error"], flush=True)
        else:
            print(json.dumps({k: rec[k] for k in
                              ("trace_s", "dominant", "roofline_fraction",
                               "useful_ratio")}, default=str), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")

    if args.jobs <= 1:
        for cell in todo:
            write(_cell_or_error(*cell))
        return
    # the longest traces first (train steps, the deepest models), each
    # record written as its cell ends
    todo.sort(key=_cost_order)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                mp_context=ctx) as pool:
        for fut in concurrent.futures.as_completed(
                [pool.submit(_cell_or_error, *cell) for cell in todo]):
            write(fut.result())


def _cost_order(cell) -> tuple:
    """A sort key putting the slowest cells to trace first: train steps
    (more microbatches on the one-pod mesh), then prefill, decode and
    the eigen steps; deeper models first within a kind."""
    arch, shape, multi_pod, _ = cell
    if arch == "flasheigen":
        return (3, 0, 0)
    kind = SHAPES[shape].kind
    return ({"train": 0, "prefill": 1, "decode": 2}[kind], multi_pod,
            -configs.get(arch).n_layers)


if __name__ == "__main__":
    main()
