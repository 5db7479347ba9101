"""The port's dry run (`repro_torch.launch.dryrun`), its collective cost
(`repro_torch.utils.collective_cost`), the kernels' meta path and the
roofline tables, against the reference's where it has a counterpart.

`repro.launch.dryrun` forces 512 host devices when it is imported, so
its values are read once, in one subprocess (as tests/test_dryrun.py
runs it), never in a pytest worker. `repro.utils.hlo_analysis` and
`repro.launch.roofline` import no JAX and run in this process.

Every count here is exact: the dry run's collective bytes are held to
the design's (`Sharding.analytic_bytes`, `dspmm.design_bytes`) and its
FLOPs to a hand count of the products, on meshes of four or eight
ranks and reduced configs, the smallest that show each property.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as ref_base
from repro.launch import roofline as ref_roofline
from repro.utils import hlo_analysis
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.dist import comm
from repro_torch.dist.comm import DryMesh
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import ops
from repro_torch.kernels.flashattn_ref import attention_ref
from repro_torch.kernels.gram_ref import gram_ref
from repro_torch.kernels.spmm_ref import coo_spmm_ref, spmm_dense_ref
from repro_torch.kernels.tsgemm_ref import tsgemm_ref
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.train.sharded import Sharding
from repro_torch.utils import collective_cost as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
QWEN = dataclasses.replace(configs.reduced("qwen2-1.5b"), remat=True)
TRAIN = ShapeConfig("t", 16, 8, "train")       # 8 rows of 16 tokens
MESHES = {False: "16x16", True: "2x16x16"}


# ------------------------------------------------------------ the reference
@pytest.fixture(scope="module")
def ref_values():
    """The reference dry run's helpers over its own cells, from one
    subprocess with its 512 host devices."""
    code = textwrap.dedent("""
        import json
        from repro import configs
        from repro.configs.base import SHAPES
        from repro.launch import dryrun as D
        from repro.launch.mesh import make_production_mesh
        meshes = {m: make_production_mesh(multi_pod=m) for m in (0, 1)}
        out = {"cells": D.all_cells(), "variants": D.VARIANTS,
               "flops": {}, "mb": {}, "acct": {}}
        for arch, shape in D.all_cells():
            out["flops"][f"{arch}/{shape}"] = D.model_flops_of(arch, shape)
            if arch == "flasheigen":
                for v in (None, "opt-eigen"):
                    out["acct"][f"{shape}/{v}"] = D.accounting_cost(
                        arch, shape, v)
                continue
            for m, mesh in meshes.items():
                out["mb"][f"{arch}/{shape}/{m}"] = D.microbatch_policy(
                    configs.get(arch), SHAPES[shape], mesh)
        print("JSON" + json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JSON")]
    return json.loads(line[-1][4:])


def test_shapes_and_cells_equal_the_reference(ref_values):
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    for cfg in configs.ARCHS.values():
        for shape in SHAPES.values():
            ref_shape = ref_base.SHAPES[shape.name]
            ref_cfg = ref_base.ArchConfig(**dataclasses.asdict(cfg))
            assert shape_applicable(cfg, shape) == \
                ref_base.shape_applicable(ref_cfg, ref_shape)
    assert [list(c) for c in dryrun.all_cells()] == ref_values["cells"]
    assert dryrun.VARIANTS == ref_values["variants"]


def test_helpers_equal_the_reference_on_every_cell(ref_values):
    for arch, shape in dryrun.all_cells():
        key = f"{arch}/{shape}"
        assert dryrun.model_flops_of(arch, shape) == ref_values["flops"][key]
        if arch == "flasheigen":
            for v in (None, "opt-eigen"):
                assert dryrun.accounting_cost(arch, shape, v) == \
                    ref_values["acct"][f"{shape}/{v}"], (key, v)
            continue
        for m in (0, 1):
            assert dryrun.microbatch_policy(
                configs.get(arch), SHAPES[shape],
                make_production_mesh(multi_pod=bool(m))) == \
                ref_values["mb"][f"{key}/{m}"], (key, m)
    with pytest.raises(ValueError):
        dryrun.accounting_cost("yi-9b", "train_4k")


# ------------------------------------------------------------ collective cost
_HLO_OP = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
           "all_reduce": "all-reduce", "all_to_all": "all-to-all",
           "permute": "collective-permute"}


def _hlo_line(kind: str, dtype: str, dims: tuple, g: int, n_dev: int):
    """One HLO instruction of `kind` whose result is dtype[dims], over
    groups of g (the iota form of replica_groups)."""
    shape = f"{dtype}[{','.join(map(str, dims))}]{{1,0}}"
    groups = (f", replica_groups=[{n_dev // g},{g}]<=[{n_dev}]"
              if kind != "permute" else
              ", source_target_pairs={{0,1},{1,0}}")
    return (f"  %c.1 = {shape} {_HLO_OP[kind]}({shape} %p.0)"
            f"{groups}, channel_id=1")


@pytest.mark.parametrize("g", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", list(_HLO_OP))
def test_collective_cost_equals_hlo_analysis(kind, g):
    """For every dtype of the reference's table: the reference's bytes
    from an HLO line whose result is dtype[6, 8·g], the port's from the
    tensor a mesh counts (a reduce-scatter's input is g results)."""
    n_dev = 32
    for dtype, size in hlo_analysis._DTYPE_BYTES.items():
        dims = (6, 8 * g)
        result = math.prod(dims) * size
        counted = result * g if kind == "reduce_scatter" else result
        want = hlo_analysis.collective_bytes(
            _hlo_line(kind, dtype, dims, g, n_dev), n_dev)
        got = cc.collective_cost([(kind, g, 1, counted)])
        assert got.pop("bytes") == {kind: counted}
        assert got == want, (dtype, got, want)


def test_collective_cost_sums_calls_and_keeps_unpriced_bytes():
    calls = [("all_gather", 4, 3, 4096), ("all_gather", 2, 1, 512),
             ("all_reduce", 8, 2, 64), ("reduce_scatter", 1, 5, 100),
             ("scatter", 8, 1, 800)]
    got = cc.collective_cost(calls)
    assert got["all-gather"] == 4096 * 3 / 4 + 512 / 2
    assert got["count_all-gather"] == 4
    assert got["all-reduce"] == 2 * 64 * 7 / 8
    assert "reduce-scatter" not in got          # a group of one
    assert got["total"] == got["all-gather"] + got["all-reduce"]
    assert got["bytes"] == {"all_gather": 4608, "all_reduce": 64,
                            "reduce_scatter": 100, "scatter": 800}
    with pytest.raises(ValueError):
        cc.wire_bytes("broadcast", 8, 2)


# ------------------------------------------------------------ DryMesh
@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2), (1, 4, 1)])
def test_dry_mesh_groups_and_collectives(shape):
    for rank in range(math.prod(shape)):
        dry = DryMesh(shape, rank)
        lists = comm.group_lists(*shape)
        for axis, groups in lists.items():
            assert dry.group_ranks(axis) in groups
            assert rank in dry.group_ranks(axis)
        assert dry.group_ranks("all") == list(range(dry.size))
        x = torch.empty((3, 5), dtype=torch.bfloat16, device="meta")
        n_rows, n_model = dry.r_groups, dry.m_groups
        assert dry.all_gather(x, "rows").shape == (3 * n_rows, 5)
        assert dry.all_gather(x, "model", dim=1).shape == (3, 5 * n_model)
        y = torch.empty((4 * n_model, 2), device="meta")
        assert dry.reduce_scatter(y, "model").shape == (4, 2)
        assert dry.all_reduce(y, "pod").shape == y.shape
        assert dict(dry.bytes) == {
            "all_gather": 3 * 5 * 2 * (n_rows + n_model),
            "reduce_scatter": 4 * n_model * 2 * 4,
            "all_reduce": 4 * n_model * 2 * 4}
        assert dry.calls[("all_gather", "model")] == [1, 3 * 5 * 2 * n_model]
        assert dry.calls[("all_reduce", "pod")] == [1, 4 * n_model * 2 * 4]
        dry.reset_counters()
        assert not dry.bytes and not dry.calls
    assert DryMesh(MeshShape(("data", "model"), (16, 16))).shape == {
        "pod": 1, "data": 16, "model": 16}


def test_links_price_a_group_inside_one_node_as_nvlink():
    assert dryrun.link_of(range(8)) == "nvlink"
    assert dryrun.link_of([8, 9, 10, 15]) == "nvlink"
    assert dryrun.link_of(range(16)) == "network"
    assert dryrun.link_of([0, 16, 32]) == "network"
    # rank 0 of (1, 4, 4): its model group (ranks 0-3) is one node, its
    # row group (ranks 0, 4, 8, 12) spans two
    dry = DryMesh((1, 4, 4), 0)
    dry.all_gather(torch.empty(8, device="meta"), "model")
    dry.all_gather(torch.empty(8, device="meta"), "rows")
    _, links, seconds = dryrun.price_collectives(dry)
    wire = 8 * 4 * 4 * 3 / 4            # 128 gathered bytes, g = 4
    assert links == {"all-gather": {"nvlink": wire, "network": wire}}
    assert seconds == wire / dryrun.NVLINK_BW + wire / dryrun.NET_BW


def test_h100_constants_and_no_tpu_constant_in_the_port():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW,
            dryrun.NET_BW, dryrun.NODE_GPUS) == (989e12, 3.35e12, 450e9,
                                                 50e9, 8)
    before = os.environ.get("XLA_FLAGS")
    code = "import repro_torch.launch.dryrun, os; " \
           "print(os.environ.get('XLA_FLAGS'))"
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.stdout.strip() == "None", res.stdout + res.stderr
    assert os.environ.get("XLA_FLAGS") == before
    for root, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                for tpu in ("197e12", "819e9", "XLA_FLAGS"):
                    assert tpu not in text, (f, tpu)


# ------------------------------------------------------------ meta kernels
class _Shapes(TorchDispatchMode):
    """Every op and output shape seen."""

    def __init__(self):
        super().__init__()
        self.ops, self.shapes = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(str(func))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_flash_allocates_no_score_matrix():
    """Forward and backward of a causal GQA call on meta tensors: no op
    makes an (Sq, Sk) tensor, the trace holds less than one head's
    scores, and the flops are the design's (2 products forward, 7
    backward, halved under causal)."""
    b, h, hkv, s, d = 1, 4, 2, 512, 16
    q = _meta(b, h, s, d).requires_grad_()
    k = _meta(b, hkv, s, d).requires_grad_()
    v = _meta(b, hkv, s, d).requires_grad_()
    rec = _Shapes()
    tr = dryrun._Trace((q, k, v))
    with FlopCounterMode(display=False) as fc, tr, rec:
        out = ops.flash_attention(q, k, v, causal=True)
        out.sum().backward()
    assert not [sh for sh in rec.shapes if sh[-2:] == (s, s)], rec.shapes
    assert "repro_torch.flash_attention.default" in rec.ops
    assert "repro_torch.flash_attention_bwd.default" in rec.ops
    assert tr.peak < s * s * 4
    assert fc.get_total_flops() == (2 + 7) * 2 * b * h * s * s * d // 2
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    # a model layer's attention takes the same route on meta tensors
    from repro_torch.models import attention as att
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(QWEN, n_layers=1)
    p = tf.init_model(0, cfg, device="meta")
    layer = {k2: {k3: v3[0] for k3, v3 in v2.items()}
             for k2, v2 in p["stack"]["l0"]["attn"].items()}
    rec = _Shapes()
    with rec:
        att.attn_forward(cfg, layer, _meta(2, s, cfg.d_model),
                         torch.arange(s, dtype=torch.float32,
                                      device="meta"))
    assert not [sh for sh in rec.shapes if sh[-2:] == (s, s)]


def test_meta_tensors_take_the_shape_only_path_cpu_the_plain_one():
    """Each kernel's wrapper: a meta tensor gets outputs of the kernel's
    shapes through its `repro_torch::` operator and its flop formula; a
    CPU tensor gets the plain version's values; the operators refuse
    any tensor but a meta one."""
    g = np.random.default_rng(0)
    cpu = lambda *s: torch.from_numpy(g.standard_normal(s).astype(
        np.float32))
    a, bm, c0 = cpu(64, 8), cpu(8, 4), cpu(64, 4)
    blocks, x = cpu(3, 8, 8), cpu(24, 2)
    cols = torch.tensor([0, 2, 1], dtype=torch.int32)
    ptr = torch.tensor([0, 1, 3], dtype=torch.int32)
    r = torch.tensor([0, 5, 5], dtype=torch.int32)
    c = torch.tensor([3, 1, 2], dtype=torch.int32)
    w = cpu(3)
    q, kv = cpu(1, 2, 32, 16), cpu(1, 1, 32, 16)
    calls = {
        "gram": (lambda t, kw: ops.gram(t(a), t(c0), **kw),
                 lambda: gram_ref(a, c0), (8, 4), 2 * 64 * 8 * 4),
        "tsgemm": (lambda t, kw: ops.tsgemm(t(a), t(bm), alpha=-1.0,
                                            beta=1.0, c0=t(c0), **kw),
                   lambda: tsgemm_ref(a, bm, alpha=-1.0, beta=1.0, c0=c0),
                   (64, 4), 2 * 64 * 8 * 4),
        "spmm_blocks": (lambda t, kw: ops.spmm_blocks(
            t(blocks), t(cols), t(ptr), t(x), **kw), None, (16, 2),
            2 * 3 * 8 * 8 * 2),
        "coo_spmm": (lambda t, kw: ops.coo_spmm(t(r), t(c), t(w), t(x), 6,
                                                **kw),
                     lambda: coo_spmm_ref(r, c, w, x, 6), (6, 2),
                     2 * 3 * 2),
        "flash_attention": (lambda t, kw: ops.flash_attention(
            t(q), t(kv), t(kv), causal=False, **kw),
            lambda: attention_ref(q, kv, kv, causal=False), (1, 2, 32, 16),
            2 * 2 * 2 * 32 * 32 * 16),
    }
    on_meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    for name, (call, plain, shape, flops) in calls.items():
        rec = _Shapes()
        with FlopCounterMode(display=False) as fc, rec:
            out = call(on_meta, {})
        assert out.device.type == "meta" and tuple(out.shape) == shape
        assert f"repro_torch.{name}.default" in rec.ops, (name, rec.ops)
        assert fc.get_total_flops() == flops, name
        got = call(lambda t: t, {})
        assert got.device.type == "cpu"
        if plain is not None:
            assert torch.equal(got, plain()), name
        # impl="ref" is the plain version on any device, meta too (but
        # the SpMM's, whose block rows come from row_ptr's values)
        if name != "spmm_blocks":
            rec = _Shapes()
            with rec:
                call(on_meta, {"impl": "ref"})
            assert f"repro_torch.{name}.default" not in rec.ops
    with pytest.raises(NotImplementedError, match="meta tensors only"):
        kmeta.gram(a, c0)
    dense = cpu(6, 24)
    assert torch.equal(spmm_dense_ref(dense, x), dense @ x)


# ------------------------------------------------------------ dry programs
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("rank", range(4))
def test_dry_train_step_counts_the_design(rank, fsdp):
    """Reduced qwen2-1.5b (remat on) on rank `rank` of a (1, 2, 2)
    DryMesh, 8 rows of 16 tokens in 2 microbatches: the traced step's
    collective bytes equal `Sharding.analytic_bytes(2)` by kind, and its
    arguments the held blocks, this rank's rows and the step counter."""
    cfg = dataclasses.replace(QWEN, use_fsdp=fsdp)
    run, args, dry, arg_bytes, design, meta = dryrun.lm_program(
        cfg, TRAIN, (1, 2, 2), rank=rank, num_microbatches=2)
    rec = dryrun.analyze(run, args, dry, arg_bytes, design, 1.0)
    shards = Sharding(cfg, DryMesh((1, 2, 2), rank))
    assert rec["collective_bytes"] == {
        k: v for k, v in shards.analytic_bytes(2).items() if v}
    assert rec["design_match"] and meta["microbatches"] == 2
    held = shards.held_bytes()
    batch_rows = 8 // 2                  # two row groups
    assert rec["memory"]["argument_size_in_bytes"] == (
        held["params"] + held["moments"] + 4 + 2 * batch_rows * 16 * 4)
    assert rec["n_devices"] == 4 and rec["collective_per_device"]["total"]
    assert rec["flops_per_device"] > 0 and rec["memory"][
        "temp_size_in_bytes"] > 0


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["float32", "compressed"])
@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2)])
def test_dry_eigen_step_counts_the_design(shape, compressed):
    for rank in range(math.prod(shape)):
        run, args, dry, arg_bytes, design, meta = dryrun.eigen_program(
            5000, 40000, b=4, nb_v=3, mesh=shape, compressed=compressed,
            rank=rank)
        rec = dryrun.analyze(run, args, dry, arg_bytes, design, 1.0)
        assert rec["collective_bytes"] == design and rec["design_match"]
        n_pad, s = meta["n_pad"], meta["n_pad"] // dry.size
        assert design == {
            "all_gather": n_pad // dry.m_groups * 4 * (2 if compressed
                                                       else 4),
            "reduce_scatter": n_pad // dry.r_groups * 4 * 4,
            "all_reduce": (2 * 3 * 16 + 2 * 16) * 4}
        # the SpMM over the panel's edges; CGS2's two passes of a gram
        # and an update against each of the nb_v blocks; CholQR2's two
        # grams, two updates and two (b, b) triangle products
        e, b = meta.get("e_pad", meta["e_loc"]), 4
        assert rec["flops_per_device"] == (
            2 * e * b + 2 * 3 * 4 * s * b * b + 2 * 4 * s * b * b
            + 2 * 2 * b ** 3)


def _dense_products(cfg, rows: int, seq: int) -> tuple[int, int, int]:
    """(projection + MLP products of one layer, its flash products, the
    head's) of a dense GQA decoder over rows × seq tokens."""
    t, d, hd = rows * seq, cfg.d_model, cfg.hd
    proj = 2 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = 2 * t * d * cfg.d_ff * (3 if cfg.glu else 2)
    flash = 2 * 2 * rows * cfg.n_heads * seq * seq * hd // 2   # causal
    head = 2 * t * d * cfg.vocab_size
    return proj + mlp, flash, head


def test_traced_flops_equal_a_hand_count_of_the_products():
    """Reduced qwen2-1.5b on one rank: the prefill traces each layer's
    products and the head's once; the train step (remat on, 2
    microbatches) the forward, the recompute of every layer (flash's
    forward included), the two backward products of each linear, and
    flash's 7 backward products for its 2 forward ones."""
    cfg = QWEN
    mm, fa, head = _dense_products(cfg, 8, 16)
    L = cfg.n_layers
    run, args, dry, ab, _, _ = dryrun.lm_program(
        cfg, ShapeConfig("p", 16, 8, "prefill"), (1, 1, 1))
    assert dryrun.trace(run, args)["flops"] == L * (mm + fa) + head
    # the recompute stops once it has rebuilt what the backward saves: the
    # layer's last product (the MLP's down projection) is not run again
    down = 2 * 8 * 16 * cfg.d_ff * cfg.d_model
    run, args, dry, ab, _, _ = dryrun.lm_program(
        cfg, TRAIN, (1, 1, 1), num_microbatches=2)
    assert dryrun.trace(run, args)["flops"] == (
        L * (mm * (1 + 2) + (mm - down) + fa * (1 + 1) + fa * 7 // 2)
        + 3 * head)


_PROGRAMS = {
    "qwen2-train": lambda: dryrun.lm_program(QWEN, TRAIN, (1, 2, 2), rank=1,
                                             num_microbatches=2),
    "grok-train": lambda: dryrun.lm_program(
        dataclasses.replace(configs.reduced("grok-1-314b"), remat=True),
        TRAIN, (1, 2, 2), num_microbatches=1),
    "qwen2-prefill": lambda: dryrun.lm_program(
        QWEN, ShapeConfig("p", 16, 4, "prefill"), (1, 2, 2)),
    "mamba2-decode": lambda: dryrun.lm_program(
        configs.reduced("mamba2-780m"), ShapeConfig("d", 32, 4, "decode"),
        (1, 2, 2)),
    "eigen-compressed": lambda: dryrun.eigen_program(
        5000, 40000, b=4, nb_v=3, mesh=(2, 2, 2), compressed=True),
}


@pytest.mark.parametrize("name", list(_PROGRAMS))
def test_trace_counts_the_flops_flop_counter_mode_counts(name):
    """The trace's one dispatch mode applies FlopCounterMode's formulas:
    its count equals FlopCounterMode's own over the same program."""
    run, args, *_ = _PROGRAMS[name]()
    got = dryrun.trace(run, args)["flops"]
    run, args, *_ = _PROGRAMS[name]()
    with FlopCounterMode(display=False) as fc:
        run()
    assert got == fc.get_total_flops() > 0


@pytest.mark.parametrize("name", list(_PROGRAMS))
def test_trace_counts_the_same_with_and_without_its_cache(name):
    """A repeated op takes its outputs' shapes from the trace's cache:
    FLOPs, bytes, peak and output bytes equal those of a trace that runs
    every op."""
    run, args, *_ = _PROGRAMS[name]()
    run()               # fill the model's own caches (rope_freqs) first
    counts = []
    for cache in (False, True):
        run, args, *_ = _PROGRAMS[name]()
        t = dryrun.trace(run, args, cache=cache)
        counts.append({k: v for k, v in t.items() if k != "trace_s"})
    assert counts[0] == counts[1]


def test_trace_cache_keys_by_shape_type_and_value():
    """Outputs from the cache keep the op's own shapes, strides and types:
    a float scalar and an int one promote an int tensor differently, and
    a transposed input gives its strides to the output."""
    x = _meta(4, 6, dtype=torch.int32)
    tr = dryrun._Trace(())
    with tr:
        for _ in range(2):
            assert (x * 2).dtype == torch.int32
            assert (x * 2.0).dtype == torch.float32
            y = x.t() + 1
            assert y.shape == (6, 4) and y.stride() == (1, 6)
            z = torch.cat([x, x], 1)
            assert z.shape == (4, 12)
    assert len(tr._cache) == 4


# ------------------------------------------------------------ the CLI
def _cli(out, *extra):
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--out", str(out), *extra], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_cli_writes_the_reference_records_and_skips_cached_cells(tmp_path):
    """tests/test_dryrun.py's assertions on flasheigen/twitter over both
    meshes, and on one LM train cell; a rerun skips every cached cell."""
    out = tmp_path / "cells.jsonl"
    for extra in ([], ["--multi-pod"]):
        _cli(out, "--arch", "flasheigen", "--graph", "twitter", *extra)
    _cli(out, "--arch", "hubert-xlarge", "--shape", "train_4k",
         "--multi-pod")
    recs = [json.loads(ln) for ln in open(out)]
    assert {r["mesh"] for r in recs if r["arch"] == "flasheigen"} == {
        "16x16", "2x16x16"}
    for r in recs:
        assert "error" not in r, r
        assert r["n_devices"] in (256, 512)
        assert r["collective_per_device"]["total"] > 0
        assert r["step_time_bound_s"] > 0
        assert r["design_match"], r
        assert r["trace_s"] >= 0 and "compile_s" not in r
    before = open(out).read()
    log = _cli(out, "--arch", "flasheigen", "--graph", "twitter",
               "--both-meshes")
    assert log.count("(cached)") == 2 and open(out).read() == before


# ------------------------------------------------------------ roofline
def _records():
    """Two meshes, a baseline and a variant, one error."""
    recs = []
    for i, (arch, shape, mesh, variant) in enumerate([
            ("yi-9b", "train_4k", "16x16", "baseline"),
            ("yi-9b", "train_4k", "2x16x16", "baseline"),
            ("yi-9b", "train_4k", "16x16", "opt-prefill"),
            ("flasheigen", "page", "16x16", "baseline")]):
        terms = {"compute_s": 0.5 + i, "memory_s": 2.0 / (i + 1),
                 "collective_s": 1e-4 * i}
        recs.append({
            "arch": arch, "shape": shape, "mesh": mesh, "variant": variant,
            **terms, "dominant": max(terms, key=terms.get),
            "step_time_bound_s": max(terms.values()),
            "model_flops": 1.5e15 * (i + 1), "useful_ratio": 0.25 * i,
            "roofline_fraction": 0.01 * i,
            "per_device_bytes_resident": 3e9 * (i + 1),
            "compile_s": 12.0 + i, "trace_s": 0.5 + i,
            "collective_per_device": {"all-gather": 1e6 * i,
                                      "all-reduce": 2e3, "total": 1.0}})
    recs.append({"arch": "grok-1-314b", "shape": "train_4k",
                 "mesh": "16x16", "variant": "baseline", "error": "X"})
    return recs


def test_roofline_copies_render_the_same_tables(tmp_path, capsys):
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    recs, ref = roofline.load(str(path)), ref_roofline.load(str(path))
    assert recs == ref
    for mesh in ("16x16", "2x16x16"):
        assert roofline.roofline_table(recs, mesh) == \
            ref_roofline.roofline_table(ref, mesh)
    assert roofline.variant_compare(recs) == ref_roofline.variant_compare(
        ref)
    mine = roofline.dryrun_table(recs).splitlines()
    theirs = ref_roofline.dryrun_table(ref).splitlines()
    drop = lambda line: line.split("|")[:4] + line.split("|")[5:]
    assert [drop(a) for a in mine] == [drop(b) for b in theirs]
    assert "trace s" in mine[0] and "compile s" in theirs[0]
    assert [a.split("|")[4].strip() for a in mine[2:]] == [
        f"{r['trace_s']:.1f}" for r in sorted(
            (r for r in recs if r["variant"] == "baseline"),
            key=lambda r: (r["arch"], r["shape"], r["mesh"]))]
    roofline.main(["--jsonl", str(path)])
    assert "### Roofline — multi-pod 2x16x16" in capsys.readouterr().out


def test_roofline_bench_reads_the_port_records(tmp_path, capsys):
    from repro_torch.benchmarks import bench_roofline, run
    path = tmp_path / "r.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    rows = bench_roofline.run([], path=str(path))
    assert [r[0] for r in rows] == ["roofline_16x16", "roofline_2x16x16",
                                    "roofline_16x16", "roofline_16x16",
                                    "roofline_16x16"]
    assert rows[-1][3] == "ERROR=X"
    assert bench_roofline.RESULTS.endswith(
        os.path.join("results", "dryrun_torch.jsonl"))
    assert bench_roofline.run([], path=str(tmp_path / "none"))[0][1] == \
        "missing"
    run.main(["--device", "cpu", "roofline"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,case,us_per_call,derived"
    assert all(ln.startswith(("roofline_", "roofline,")) for ln in lines[1:])
