"""The port's training path against the JAX package, on the CPU.

Checkpoints of `(params, AdamWState)` cross between the packages both
ways, leaves named as JAX names them ("1/.step", "1/.m/..."); the token
pipeline's batches are the reference's bit for bit; the schedules,
`adamw.update` and `global_norm_clip` match on identical trees; one
`build_train_step` step matches the reference's; the trainer's loss
falls, a restart is bit-identical, and a checkpoint of the JAX trainer
resumes in the port's.

Tolerances, each with its reason:
- schedules: rtol 1e-6 (float32 in the same order; cos and sqrt may
  round differently in the last bit);
- `adamw.update` on identical float32 inputs: rtol 1e-6 (the same
  float32 operations in the same order);
- one train step: loss rtol 1e-5 and grad norm rtol 1e-5 (the same
  model in float32, sums in another order); each leaf of the moments m
  and v to 1e-4 of its Frobenius norm (they are (1-b1)·g and (1-b2)·g²,
  as close as the gradients, which `test_torch_grads.py` holds so);
  parameters to 2·lr + 1e-6 absolute: at step 1 Adam moves
  every parameter by lr·sign(g) (m̂/√v̂ = g/|g|), so a gradient element
  at rounding level whose sign differs between the packages moves its
  parameter the other way, 2·lr apart, and nowhere further;
- the resumed trainer's step 6 against the JAX trainer's uninterrupted
  one: losses rtol 1e-4 (float32, after three steps of Adam on either
  side) and parameters within 2·lr·(steps) + 1e-5 of each other for the
  same sign reason.
"""
import shutil
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt import checkpoint as ref_ckpt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import steps as ref_steps
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import train as ref_train
from repro_torch import configs
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.convert import params_from_arrays
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import steps
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw, schedule
from repro_torch.train import TrainConfig, train


def quiet(*_):
    pass


class S(NamedTuple):
    step: object
    m: object


def _np_tree(tree):
    return adamw.tree_map(lambda t: t.detach().numpy(), tree)


def _leaves_equal(a, b):
    la, lb = adamw.tree_leaves(a), adamw.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------- ckpt
def test_namedtuple_checkpoint_round_trip(tmp_path):
    """A NamedTuple inside the tree: named ".field", rebuilt as its type
    (the port named it by index and could not rebuild it)."""
    tree = ({"a": torch.arange(3.0)},
            S(torch.tensor(2, dtype=torch.int32), {"a": torch.ones(2)}))
    ckpt.save(str(tmp_path), 1, tree)
    names, _, _ = ckpt._flatten_with_paths(tree)
    assert names == ["0/a", "1/.step", "1/.m/a"]
    got, _ = ckpt.restore(str(tmp_path), 1, tree)
    assert type(got[1]) is S
    _leaves_equal(got, tree)
    # the same names as the reference gives the same tree
    ref_names, _, _ = ref_ckpt._flatten_with_paths(
        ({"a": np.arange(3.0)}, S(np.int32(2), {"a": np.ones(2)})))
    assert names == ref_names


def _small_state(seed):
    g = np.random.default_rng(seed)
    params = {"w": g.standard_normal((3, 4)).astype(np.float32),
              "rem": [{"b": g.standard_normal(4).astype(np.float32)}]}
    m = adamw.tree_map(lambda a: g.standard_normal(a.shape).astype(
        np.float32), params)
    v = adamw.tree_map(lambda a: g.random(a.shape).astype(np.float32),
                       params)
    return params, np.int32(5), m, v


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_train_state_checkpoint_crosses_packages(tmp_path, writer):
    """(params, AdamWState) saved by either package restores in the
    other, with the reference's leaf names."""
    params, step, m, v = _small_state(0)
    ref_state = (jax.tree_util.tree_map(jnp.asarray, params),
                 ref_adamw.AdamWState(step=jnp.asarray(step),
                                      m=jax.tree_util.tree_map(jnp.asarray, m),
                                      v=jax.tree_util.tree_map(jnp.asarray, v)))
    port_state = params_from_arrays(
        (params, ref_adamw.AdamWState(step=step, m=m, v=v)), device="cpu")
    assert type(port_state[1]) is adamw.AdamWState
    if writer == "ref":
        ref_ckpt.save(str(tmp_path), 7, ref_state, extra={"data_step": 7})
        like = params_from_arrays(
            (params, ref_adamw.AdamWState(step=np.int32(0),
                                          m=adamw.tree_map(np.zeros_like, m),
                                          v=adamw.tree_map(np.zeros_like, v))),
            device="cpu")
        got, extra = ckpt.restore(str(tmp_path), 7, like)
        assert type(got[1]) is adamw.AdamWState
        assert got[1].step.dtype == torch.int32
    else:
        ckpt.save(str(tmp_path), 7, port_state, extra={"data_step": 7})
        like = jax.tree_util.tree_map(jnp.zeros_like, ref_state)
        got, extra = ref_ckpt.restore(str(tmp_path), 7, like)
        assert isinstance(got[1], ref_adamw.AdamWState)
    assert extra == {"data_step": 7}
    with open(tmp_path / "step_0000000007" / "manifest.json") as f:
        names = __import__("json").load(f)["names"]
    assert names[:2] == ["0/rem/0/b", "0/w"]
    assert names[2:] == ["1/.step", "1/.m/rem/0/b", "1/.m/w",
                         "1/.v/rem/0/b", "1/.v/w"]
    _leaves_equal(got, (params, (step, m, v)))


def test_convert_keeps_tuples_and_namedtuples():
    tree = {"t": (np.ones(2, np.float32), [np.zeros(1, np.float32)]),
            "s": S(np.int32(1), {"a": np.ones(1, np.float32)})}
    got = params_from_arrays(tree, device="cpu")
    assert type(got["t"]) is tuple and type(got["t"][1]) is list
    assert type(got["s"]) is S and got["s"].step.dtype == torch.int32


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("from_file", [False, True])
def test_pipeline_batches_bit_for_bit(tmp_path, from_file):
    token_file = None
    if from_file:
        token_file = str(tmp_path / "tokens.npy")
        np.save(token_file, np.random.default_rng(1).integers(
            0, 500, 5000).astype(np.int32))
    kw = dict(vocab_size=500, seq_len=33, global_batch=6, seed=4,
              token_file=token_file)
    got, want = TokenPipeline(DataConfig(**kw)), RefPipeline(
        RefDataConfig(**kw))
    for step in (0, 1, 7, 123):
        a, b = got.batch(step), want.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        for host in range(3):
            for k, x in got.host_shard(a, host, 3).items():
                np.testing.assert_array_equal(
                    x, want.host_shard(b, host, 3)[k])
    with pytest.raises(ValueError):
        got.host_shard(a, 0, 4)


# ---------------------------------------------------------------- optim
def test_schedules_match_reference():
    steps_ = np.arange(0, 140, dtype=np.int32)
    for s in steps_:
        np.testing.assert_allclose(
            float(schedule.warmup_cosine(int(s), peak_lr=3e-4, warmup=20,
                                         total=120)),
            float(ref_schedule.warmup_cosine(s, peak_lr=3e-4, warmup=20,
                                             total=120)), rtol=1e-6)
        np.testing.assert_allclose(
            float(schedule.warmup_rsqrt(torch.tensor(s), peak_lr=1e-3,
                                        warmup=10)),
            float(ref_schedule.warmup_rsqrt(s, peak_lr=1e-3, warmup=10)),
            rtol=1e-6)
    assert schedule.warmup_cosine(torch.tensor(3, dtype=torch.int32),
                                  peak_lr=1.0, warmup=5,
                                  total=9).dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_and_clip_match_reference(dtype):
    g = np.random.default_rng(3)

    def draw(scale=1.0):
        r = lambda *s: (scale * g.standard_normal(s)).astype(np.float32)
        return {"b": r(5), "a": [r(3, 4), r(2)]}
    params, grads, m, v = draw(), draw(0.1), draw(0.01), adamw.tree_map(
        np.abs, draw(0.001))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    rg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), grads)
    rst = ref_adamw.AdamWState(step=jnp.int32(4),
                               m=jax.tree_util.tree_map(jnp.asarray, m),
                               v=jax.tree_util.tree_map(jnp.asarray, v))
    pp, pg = (params_from_arrays(jax.tree_util.tree_map(np.asarray, t),
                                 device="cpu") for t in (rp, rg))
    pst = params_from_arrays(jax.tree_util.tree_map(np.asarray, rst),
                             device="cpu")
    want_c, want_n = ref_adamw.global_norm_clip(rg, 0.5)
    got_c, got_n = adamw.global_norm_clip(pg, 0.5)
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    for a, b in zip(adamw.tree_leaves(got_c), jax.tree_util.tree_leaves(want_c)):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # update on identical inputs: the clipped gradients crossed over
    rc = jax.tree_util.tree_map(jnp.asarray, _np_tree(got_c))
    want_p, want_s = ref_adamw.update(rst, rc, rp, lr=jnp.float32(1e-2))
    got_p, got_s = adamw.update(pst, got_c, pp, lr=torch.tensor(1e-2))
    assert int(got_s.step) == int(want_s.step) == 5
    for a, b in zip(adamw.tree_leaves((got_p, got_s.m, got_s.v)),
                    jax.tree_util.tree_leaves((want_p, want_s.m, want_s.v))):
        a = a.float().numpy()
        b = np.asarray(jnp.asarray(b, jnp.float32))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert adamw.tree_leaves(got_p)[0].dtype == pp["a"][0].dtype


def _step_inputs(cfg, rows=4, seq=8, seed=5):
    g = np.random.default_rng(seed)
    return {"tokens": g.integers(0, cfg.vocab_size, (rows, seq)).astype(
                np.int32),
            "targets": g.integers(0, cfg.vocab_size, (rows, seq)).astype(
                np.int32)}


def test_train_step_matches_reference():
    """One step of build_train_step: loss, grad norm, lr, moments and
    parameters against the reference's on the same weights and batch."""
    name, lr = "yi-9b", 1e-3
    cfg, ref_cfg = configs.reduced(name), ref_configs.reduced(name)
    arrays = _np_tree(tf.init_model(2, cfg, device="cpu"))
    batch = _step_inputs(cfg)
    kw = dict(num_microbatches=2, peak_lr=lr, warmup=0, total_steps=10)
    rp = jax.tree_util.tree_map(jnp.asarray, arrays)
    want_p, want_s, want_m = jax.jit(ref_steps.build_train_step(
        ref_cfg, **kw))(rp, ref_adamw.init(rp),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    pp = params_from_arrays(arrays, device="cpu")
    got_p, got_s, got_m = steps.build_train_step(cfg, device="cpu", **kw)(
        pp, adamw.init(pp), batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-5)
    assert int(got_s.step) == 1
    for a, b in zip(adamw.tree_leaves((got_s.m, got_s.v)),
                    jax.tree_util.tree_leaves((want_s.m, want_s.v))):
        b = np.asarray(b, np.float64)
        assert np.linalg.norm(a.numpy() - b) <= 1e-4 * max(
            np.linalg.norm(b), 1e-12)
    for a, b in zip(adamw.tree_leaves(got_p),
                    jax.tree_util.tree_leaves(want_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2 * lr + 1e-6)
    # the caller's tensors are not touched
    _leaves_equal(pp, params_from_arrays(arrays, device="cpu"))


def test_microbatched_train_matches_full():
    cfg = configs.reduced("yi-9b")
    params, opt = steps.init_all(0, cfg, device="cpu")
    batch = _step_inputs(cfg, seed=6)
    m = [steps.build_train_step(cfg, num_microbatches=n, device="cpu")(
        params, opt, batch)[2] for n in (1, 2)]
    np.testing.assert_allclose(float(m[0]["loss"]), float(m[1]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m[0]["grad_norm"]),
                               float(m[1]["grad_norm"]), rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        steps.build_train_step(cfg, num_microbatches=3, device="cpu")(
            params, opt, batch)


def test_batch_specs_and_init_all():
    for name in ("qwen2-1.5b", "hubert-xlarge", "llama-3.2-vision-90b"):
        cfg = configs.reduced(name)
        got = steps.make_batch_specs(cfg, 4, 16)
        want = ref_steps.make_batch_specs(ref_configs.reduced(name), 4, 16)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype)
    params, opt = steps.init_all(1, configs.reduced("qwen2-1.5b"),
                                 device="cpu")
    assert int(opt.step) == 0 and opt.step.dtype == torch.int32
    for p, m in zip(adamw.tree_leaves(params), adamw.tree_leaves(opt.m)):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any()


# ---------------------------------------------------------------- trainer
def test_trainer_loss_decreases(tmp_path):
    cfg = configs.reduced("qwen2-1.5b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tcfg = TrainConfig(steps=30, ckpt_every=100, ckpt_dir=str(tmp_path),
                       peak_lr=3e-3, warmup=5, log_every=1000)
    s = train(cfg, tcfg, dcfg, log=quiet, device="cpu")
    assert s["steps_run"] == len(s["losses"]) == len(s["step_s"]) == 30
    assert s["final_loss"] < s["first_loss"] - 0.3
    assert all(np.isfinite(s["grad_norms"]))


def test_restart_is_bitwise_identical(tmp_path):
    """[train 6] == [train 3, stop, restore, train 3], every leaf."""
    cfg = configs.reduced("mamba2-780m")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    for d, n in ((a_dir, 6), (b_dir, 3), (b_dir, 6)):
        train(cfg, TrainConfig(steps=n, ckpt_every=100, ckpt_dir=d,
                               log_every=1000), dcfg, log=quiet,
              device="cpu")
    like = steps.init_all(0, cfg, device="cpu")
    ta, _ = ckpt.restore(a_dir, ckpt.latest_step(a_dir), like)
    tb, _ = ckpt.restore(b_dir, ckpt.latest_step(b_dir), like)
    assert ckpt.latest_step(a_dir) == ckpt.latest_step(b_dir) == 6
    _leaves_equal(ta, tb)


def test_jax_checkpoint_resumes_in_port_trainer(tmp_path):
    """The JAX trainer's step-3 checkpoint, resumed by the port's trainer
    to step 6, against the JAX trainer's uninterrupted step 6."""
    name, lr = "qwen2-1.5b", 1e-3
    ref_cfg, cfg = ref_configs.reduced(name), configs.reduced(name)
    dkw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    tkw = dict(steps=6, ckpt_every=3, keep_ckpts=5, log_every=1000,
               peak_lr=lr, warmup=2)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = ref_train(ref_cfg, RefTrainConfig(ckpt_dir=str(ref_dir), **tkw),
                     RefDataConfig(**dkw), log=quiet)
    assert ref_ckpt.valid_steps(str(ref_dir)) == [3, 6]
    shutil.copytree(ref_dir / "step_0000000003",
                    port_dir / "step_0000000003")
    logs = []
    got = train(cfg, TrainConfig(ckpt_dir=str(port_dir), **tkw),
                DataConfig(**dkw), log=logs.append, device="cpu")
    assert logs[0] == "restored checkpoint step 3; resuming at 3"
    assert got["steps_run"] == 3
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    like = steps.init_all(0, cfg, device="cpu")
    tp, _ = ckpt.restore(str(port_dir), 6, like)
    tr, _ = ckpt.restore(str(ref_dir), 6, like)
    assert int(tp[1].step) == int(tr[1].step) == 6
    for a, b in zip(adamw.tree_leaves(tp[0]), adamw.tree_leaves(tr[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2 * lr * 3 + 1e-5)


def test_trainer_refuses_a_mesh_and_launcher_trains(tmp_path, capsys):
    """A mesh no longer raises: on a (1, 1, 1) mesh (one rank, no world)
    the sharded step is the unsharded one, losses, norms and checkpoint
    bit for bit (tests/test_torch_sharded_train.py runs four ranks)."""
    from repro_torch.dist import comm
    cfg = configs.reduced("qwen2-1.5b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    runs = {}
    for name, mesh in (("plain", None),
                       ("mesh", comm.Mesh((1, 1, 1), device="cpu"))):
        runs[name] = train(cfg, TrainConfig(
            steps=2, log_every=1000, ckpt_dir=str(tmp_path / name)), dcfg,
            mesh=mesh, log=quiet, device="cpu")
    for k in ("losses", "grad_norms"):
        assert runs["mesh"][k] == runs["plain"][k]
    like = steps.init_all(0, cfg, device="cpu")
    _leaves_equal(ckpt.restore(str(tmp_path / "mesh"), 2, like)[0],
                  ckpt.restore(str(tmp_path / "plain"), 2, like)[0])
    assert runs["mesh"]["step_bytes"][0] == {
        k: v for k, v in runs["mesh"]["analytic_bytes"].items() if v}
    s = launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps",
                           "2", "--global-batch", "2", "--seq-len", "8",
                           "--ckpt-dir", str(tmp_path / "ck"), "--device",
                           "cpu"])
    assert s["steps_run"] == 2 and "summary:" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2
