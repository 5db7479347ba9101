"""Sharded training (`train.sharded`, `train(mesh=)`) on four gloo ranks
on the CPU, against the port's unsharded `train()` and the reference's.

The reference's own sharded run cannot be the yardstick: its
`train(mesh=)` raises `ShardingTypeError` in `embed_tokens` on a forced
4-device mesh (ROADMAP.md, "Failures in the reference"). Sharding is
meant to change where state lives, never what is computed, so the
sharded runs are held to the unsharded ones of both packages.

One world of four ranks (`dist.spawn` with the package's rank function
`comm.run_calls`, a `file://` rendezvous in a temporary directory) runs
every multi-rank program of the file once, on meshes of four ranks
built in one order on every rank:

  * reduced qwen2-1.5b (float32, remat on), from the reference's step-0
    weights (a checkpoint every run resumes from), a global batch of 8 × 16
    tokens in 2 microbatches, 3 steps, on (1, 2, 2), on (1, 4, 1), with
    `use_fsdp=True` on (1, 2, 2), and with a batch of 6 rows that does
    not split over (1, 4, 1)'s four row groups (every rank keeps it all);
  * the (1, 2, 2) run's checkpoint restored onto (1, 4, 1) and (1, 1, 4);
  * the clip of a gradient tree whose replicated leaf dominates the norm;
  * a (1, 2, 2) run preempted after its first step and restarted;
  * the sharded prefill and decode steps beside the unsharded ones on
    each rank's rows (`sharded.serve_rows`), which must be the same bits.

The dry run (`launch.dryrun`) traces the (1, 2, 2) run's step on a
`DryMesh` for each rank, and its counts must equal what that rank's
`Mesh` counted.

Tolerances (those of tests/test_torch_train.py, with their reasons):
losses and grad norms rtol 1e-4 (float32 sums in another order, after
steps of Adam); parameters within 2·lr·steps + 1e-5 (Adam moves each
parameter by about lr·sign(g) a step, and a gradient element at
rounding level may change sign). Moments rtol 1e-4 of their leaf's
largest magnitude. Block shapes, byte counts and the restored blocks
are exact, and the preempted run equals the uninterrupted one bit for
bit (gloo's sums are deterministic).
"""
import dataclasses
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt import checkpoint as ref_ckpt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models import steps as ref_steps
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import train as ref_train
from repro_torch import configs
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data import DataConfig
from repro_torch.dist import comm
from repro_torch.ft.preemption import SignalAt
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import sharding as shd
from repro_torch.models import steps
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, sharded, train

NAME, LR, STEPS = "qwen2-1.5b", 1e-3, 3
CFG = dataclasses.replace(configs.reduced(NAME), remat=True)
FSDP = dataclasses.replace(CFG, use_fsdp=True)
TKW = dict(steps=STEPS, ckpt_every=100, keep_ckpts=5, log_every=1000,
           peak_lr=LR, warmup=2, num_microbatches=2)
PARAM_TOL = 2 * LR * STEPS + 1e-5
# (run, config, mesh, global batch rows)
RUNS = {"a22": (CFG, (1, 2, 2), 8), "a41": (CFG, (1, 4, 1), 8),
        "f22": (FSDP, (1, 2, 2), 8), "rep41": (CFG, (1, 4, 1), 6)}
# the global batch of the sharded prefill and decode: 4 rows of 12 tokens
SERVE_TOKENS = np.random.default_rng(7).integers(0, CFG.vocab_size, (4, 12))


def quiet(*_):
    pass


def _data(rows):
    return DataConfig(vocab_size=CFG.vocab_size, seq_len=16,
                      global_batch=rows)


@functools.lru_cache(maxsize=None)
def _initial_state():
    """The reference's step-0 state of reduced qwen2-1.5b (its
    `init_all` from `PRNGKey(0)`, jitted), as numpy."""
    ref_cfg = ref_configs.reduced(NAME)
    state = jax.jit(lambda k: ref_steps.init_all(k, ref_cfg))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, state)


def _tcfg(root, name):
    """A run's TrainConfig, its checkpoint directory holding the
    reference's step-0 state: every run, of either package, sharded or
    not, resumes from the same weights."""
    ref_ckpt.save(str(root / name), 0, _initial_state(),
                  extra={"data_step": 0})
    return TrainConfig(ckpt_dir=str(root / name), **TKW)


def _grads_for_clip():
    """A gradient tree whose replicated leaf (spec all None) holds most
    of the norm: counting it on each of its four copies would double the
    norm. The other leaves are cut over 'model', over 'data' and over
    both."""
    g = np.random.default_rng(3)
    grads = {"rep": 10 * g.standard_normal((6, 5)).astype(np.float32),
             "m": g.standard_normal((4, 8)).astype(np.float32),
             "d": g.standard_normal((8, 3)).astype(np.float32),
             "md": g.standard_normal((4, 6)).astype(np.float32)}
    specs = {"rep": (None, None), "m": (None, "model"), "d": ("data", None),
             "md": ("data", "model")}
    return grads, specs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every multi-rank program, in one world of four gloo ranks: a list
    of four ranks' results, each one per call, in `calls`' order."""
    root = tmp_path_factory.mktemp("sharded")
    calls = [(shape, launch_train.rank_main,
              (cfg, _tcfg(root, name), _data(rows)), {"log": quiet})
             for name, (cfg, shape, rows) in RUNS.items()]
    calls += [
        ((1, 4, 1), sharded.restore_state, (CFG, str(root / "a22"), STEPS),
         {}),
        ((1, 1, 4), sharded.restore_state, (CFG, str(root / "a22"), STEPS),
         {}),
        ((1, 2, 2), sharded.clip_full, (*_grads_for_clip(), 1.0), {}),
        # preempted after step 0 (rank 0 gets the signal), then restarted
        ((1, 2, 2), launch_train.rank_main,
         (CFG, _tcfg(root, "k22"), _data(8)), {"log": SignalAt(0)}),
        ((1, 2, 2), launch_train.rank_main,
         (CFG, _tcfg(root, "k22"), _data(8)), {"log": quiet}),
        ((1, 2, 2), sharded.serve_rows, (CFG, 0, SERVE_TOKENS, 2), {}),
    ]
    out = comm.spawn(comm.run_calls, (1, 2, 2), backend="gloo",
                     device="cpu", args=(calls,), timeout=900,
                     init_method=f"file://{root}/rendezvous")
    return root, out


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    """The port's unsharded runs (batches of 8 and 6 rows) and the
    reference's (8 rows): (summary, final state) by batch rows."""
    root = tmp_path_factory.mktemp("unsharded")
    like = steps.init_all(0, CFG, device="cpu")
    out = {}
    for rows in (8, 6):
        s = train(CFG, _tcfg(root, f"port{rows}"), _data(rows), log=quiet,
                  device="cpu")
        out[rows] = s, ckpt.restore(str(root / f"port{rows}"), STEPS,
                                    like)[0]
    ref_cfg = dataclasses.replace(ref_configs.reduced(NAME), remat=True)
    _tcfg(root, "ref")
    s = ref_train(ref_cfg, RefTrainConfig(ckpt_dir=str(root / "ref"), **TKW),
                  RefDataConfig(vocab_size=CFG.vocab_size, seq_len=16,
                                global_batch=8), log=quiet)
    out["ref"] = s, ckpt.restore(str(root / "ref"), STEPS, like)[0]
    out["root"] = root
    return out


def _state(root, name):
    return ckpt.restore(str(root / name), STEPS,
                        steps.init_all(0, CFG, device="cpu"))[0]


def _params_close(got, want):
    for a, b in zip(adamw.tree_leaves(got[0]), adamw.tree_leaves(want[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=PARAM_TOL)


@pytest.mark.parametrize("run", list(RUNS))
def test_sharded_train_matches_unsharded(world, unsharded, run):
    root, out = world
    rows = RUNS[run][2]
    want, want_state = unsharded[rows]
    state = _state(root, run)
    for rank in range(4):
        got = out[rank][list(RUNS).index(run)]
        assert got["steps_run"] == STEPS
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=1e-4)
    _params_close(state, want_state)
    if rows == 8:      # and the reference's unsharded run
        ref, ref_state = unsharded["ref"]
        np.testing.assert_allclose(
            [out[0][list(RUNS).index(run)][k] for k in ("first_loss",
                                                         "final_loss")],
            [ref["first_loss"], ref["final_loss"]], rtol=1e-4)
        _params_close(state, ref_state)


def _block_shape(shape, spec, mesh):
    return tuple(n // math.prod(mesh.shape[a] for a in shd._axes(e))
                 for n, e in zip(shape, spec))


@pytest.mark.parametrize("run", list(RUNS))
def test_blocks_and_collective_bytes_match_the_design(world, run):
    """Each rank holds the parameter and moment bytes the specs give, and
    every step's collective bytes equal `Sharding.analytic_bytes`."""
    root, out = world
    cfg, shape, rows = RUNS[run]
    mesh = MeshShape(("pod", "data", "model"), shape)
    meta = tf.init_model(0, cfg, device="meta")
    specs = []
    shd._map_specs(specs.append, shd.param_specs(meta, cfg, mesh))
    par = mom = 0
    for leaf, spec in zip(adamw.tree_leaves(meta), specs):
        par += math.prod(_block_shape(leaf.shape, spec, mesh)) * 4
        ospec = adamw.shard_opt_spec(spec, leaf.shape, mesh)
        mom += 2 * 4 * math.prod(_block_shape(leaf.shape, ospec, mesh))
    for rank in range(4):
        got = out[rank][list(RUNS).index(run)]
        assert got["held_bytes"] == {"params": par, "moments": mom,
                                     "specs": {"params": par,
                                               "moments": mom}}
        design = {k: v for k, v in got["analytic_bytes"].items() if v}
        assert design["all_gather"] > 0 and design["all_reduce"] > 0
        assert ("reduce_scatter" in design) == cfg.use_fsdp
        assert len(got["step_bytes"]) == STEPS
        for step in got["step_bytes"]:
            assert step == design
        assert got["peak_device_bytes"] is None


def _slices(shape, spec, mesh, coords):
    """A rank's block of a full tensor, by the spec, written out here."""
    out = []
    for n, entry in zip(shape, spec):
        index, count = 0, 1
        for a in shd._axes(entry):
            index, count = index * mesh.shape[a] + coords[a], \
                count * mesh.shape[a]
        out.append(slice(index * (n // count), (index + 1) * (n // count)))
    return tuple(out)


def test_restore_onto_other_meshes_is_exact(world):
    """The (1, 2, 2) run's checkpoint restored onto (1, 4, 1) and
    (1, 1, 4): every rank's blocks are the slices of the unsharded
    restore, bit for bit, which is the reference's `restore`."""
    root, out = world
    full = _state(root, "a22")
    ref_full, _ = ref_ckpt.restore(str(root / "a22"), STEPS, adamw.tree_map(
        lambda t: t.numpy(), full))
    for a, b in zip(adamw.tree_leaves(full), jax.tree_util.tree_leaves(
            ref_full)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    names = ckpt._flatten_with_paths(full[0])[0]
    meta = adamw.tree_leaves(tf.init_model(0, CFG, device="meta"))
    for call, shape in ((4, (1, 4, 1)), (5, (1, 1, 4))):
        mesh = MeshShape(("pod", "data", "model"), shape)
        specs = []
        shd._map_specs(specs.append, shd.param_specs(
            tf.init_model(0, CFG, device="meta"), CFG, mesh))
        ospecs = [adamw.shard_opt_spec(s, t.shape, mesh)
                  for s, t in zip(specs, meta)]
        for rank in range(4):
            coords = {"pod": 0, "data": rank // shape[2],
                      "model": rank % shape[2]}
            params, opt = out[rank][call]
            assert int(opt.step) == STEPS
            for tree, want_tree, sp in ((params, full[0], specs),
                                        (opt.m, full[1].m, ospecs),
                                        (opt.v, full[1].v, ospecs)):
                for got, want, spec, name in zip(
                        adamw.tree_leaves(tree),
                        adamw.tree_leaves(want_tree), sp, names):
                    np.testing.assert_array_equal(
                        got, want[_slices(want.shape, spec, mesh, coords)]
                        .numpy(), err_msg=f"{shape} rank {rank} {name}")


def test_sharded_checkpoint_equals_unsharded(world, unsharded):
    """A sharded run's checkpoint is the unsharded format: the same names,
    types and shapes leaf for leaf, values within the training
    tolerances, and it restores in the reference's `ckpt.restore`."""
    root, _ = world

    def manifest(path):
        with open(path / f"step_{STEPS:010d}" / "manifest.json") as f:
            return json.load(f)
    theirs = manifest(unsharded["root"] / "port8")
    want = unsharded[8][1]
    for name in ("a22", "f22"):
        mine = manifest(root / name)
        for k in ("names", "dtypes", "shapes", "extra"):
            assert mine[k] == theirs[k]
        state = _state(root, name)
        _params_close(state, want)
        for a, b in zip(adamw.tree_leaves((state[1].m, state[1].v)),
                        adamw.tree_leaves((want[1].m, want[1].v))):
            assert float((a - b).abs().max()) <= 1e-4 * float(
                b.abs().max())
        assert int(state[1].step) == STEPS


def test_clip_counts_each_block_once(world):
    """The sharded norm equals the full tree's (a replicated leaf counted
    four times would double it) and every rank's clipped blocks are the
    slices of the full clip."""
    _, out = world
    grads, specs = _grads_for_clip()
    full = {k: torch.from_numpy(v) for k, v in grads.items()}
    want, norm = adamw.global_norm_clip(full, 1.0)
    rep = float(torch.sum(full["rep"] ** 2))
    assert rep > 0.75 * float(norm) ** 2      # double counting would show
    mesh = MeshShape(("pod", "data", "model"), (1, 2, 2))
    for rank in range(4):
        got_norm, blocks = out[rank][6]
        np.testing.assert_allclose(float(got_norm), float(norm), rtol=1e-6)
        coords = {"pod": 0, "data": rank // 2, "model": rank % 2}
        for k, blk in zip(sorted(grads), blocks):
            sl = _slices(grads[k].shape, specs[k], mesh, coords)
            np.testing.assert_allclose(blk, want[k][sl].numpy(), rtol=1e-6)


def test_preempted_run_resumes_bit_identical(world):
    """Rank 0 is signalled after step 0: every rank checkpoints step 1
    and stops; the restart resumes there and ends where the
    uninterrupted run ends, every leaf bit for bit."""
    root, out = world
    for rank in range(4):
        assert out[rank][7]["steps_run"] == 1
        assert out[rank][8]["steps_run"] == STEPS - 1
    assert 1 in ckpt.valid_steps(str(root / "k22"))
    a, b = _state(root, "a22"), _state(root, "k22")
    for x, y in zip(adamw.tree_leaves(a), adamw.tree_leaves(b)):
        assert torch.equal(x, y)


def test_launcher_trains_on_a_world_and_refuses_a_wrong_backend(tmp_path):
    """`launch/train.py --world 2` trains on a (1, 1, 2) gloo mesh (the
    debug mesh of 2) and resumes from its checkpoint; nccl over CPU
    tensors raises rather than falling back."""
    argv = ["--arch", NAME, "--reduced", "--steps", "2", "--global-batch",
            "2", "--seq-len", "8", "--ckpt-dir", str(tmp_path / "ck"),
            "--device", "cpu", "--world", "2", "--backend", "gloo"]
    s = launch_train.main(argv)
    assert s["steps_run"] == 2 and np.isfinite(s["losses"]).all()
    assert s["step_bytes"][0] == {k: v for k, v in
                                  s["analytic_bytes"].items() if v}
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2
    with pytest.raises(ValueError, match="nccl"):
        launch_train.main(argv[:-1] + ["nccl"])


def test_sharded_prefill_and_decode_are_bit_equal(world):
    """On every rank, the prefill logits of its 2 rows, 2 decode steps'
    logits and the whole cache after them equal the unsharded steps'
    on the same rows, bit for bit."""
    _, out = world
    for rank in range(4):
        got = out[rank][-1]
        sharded_prefill, plain_prefill = got["prefill"]
        assert sharded_prefill.shape == (2, 12, CFG.vocab_size)
        np.testing.assert_array_equal(sharded_prefill, plain_prefill)
        assert len(got["decode"][0]) == 2
        for a, b in zip(*got["decode"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(*got["cache"]):
            np.testing.assert_array_equal(a, b)
    # the row groups saw different rows
    assert not np.array_equal(out[0][-1]["prefill"][0],
                              out[2][-1]["prefill"][0])


def test_dry_run_counts_what_each_rank_counted(world):
    """The a22 run's step traced on a (1, 2, 2) DryMesh for each rank:
    collective bytes by kind equal what that gloo rank's `Mesh` counted
    in every step, and the arguments its held blocks, its batch rows and
    the step counter."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    _, out = world
    cfg, shape, rows = RUNS["a22"]
    for rank in range(4):
        got = out[rank][list(RUNS).index("a22")]
        run, args, dry, arg_bytes, design, _ = dryrun.lm_program(
            cfg, ShapeConfig("a22", 16, rows, "train"), shape, rank=rank,
            num_microbatches=TKW["num_microbatches"])
        rec = dryrun.analyze(run, args, dry, arg_bytes, design, 1.0)
        for step in got["step_bytes"]:
            assert rec["collective_bytes"] == step
        held = got["held_bytes"]
        assert arg_bytes == held["params"] + held["moments"] + 4 + \
            2 * (rows // 2) * 16 * 4
