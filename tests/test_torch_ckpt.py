"""Checkpoint/resume in the port against the JAX package.

  * the snapshot format crosses packages both ways: a tree of float32,
    float64, int, bool and bf16 leaves in nested dicts and a list, written
    by either package, restores in the other with equal names, dtypes,
    shapes and bytes;
  * cross-package resume: a solve suspended by a stand-in preemption
    guard in one package resumes in the other, on the RAM and the SAFS
    tier, with eigenvalues at rtol 1e-5 of the writer's own resumed run,
    the same `resumed_step` and equal `IOStats` (Krylov–Schur at tol
    1e-6; LOBPCG at tol 1e-4, since at 1e-5 the reference's float32
    floor on this graph changes its iteration count);
  * a port solve suspended and resumed is bit-equal to the uninterrupted
    one (Krylov–Schur and LOBPCG, RAM and SAFS);
  * the reference's suspend/resume cases (`tests/test_faults.py`), on
    the port alone: every resumed solve is held to the port's own
    uninterrupted solve (the reference's LOBPCG rows fail, because its
    uninterrupted solve does not converge).

The kill matrix, the primitives of `tests/test_checkpoint.py` and the
checkpoint-sourced repair are in tests/test_torch_ckpt_faults.py, which
imports this file's fixture and helpers.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.ckpt import checkpoint as rck
from repro.ckpt.solver import CheckpointPolicy as RefPolicy
from repro.ckpt.solver import SolveSuspended as RefSuspended
from repro.graphs import normalized_adjacency, pack_tiles, rmat_graph
import repro_torch.core as P
from repro_torch.ckpt import checkpoint as ck
from repro_torch.ckpt import CheckpointPolicy, SolveSuspended
from repro_torch.convert import tiled_from_arrays
from repro_torch.safs import RetryPolicy

RTOL = 1e-5
FAST_RETRY = RetryPolicy(max_attempts=3, base_delay=1e-4, max_delay=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread, restored after each test: the solves are many
    small products, which run slowest when six xdist workers each spread
    them over every core (test_torch_hvp.py does the same)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tm():
    """The 400-vertex graph of `tests/test_faults.py`, as the reference's
    TiledMatrix (`tm[0]`) and the port's (`tm[1]`)."""
    n = 400
    r, c, v = rmat_graph(n, 4000, seed=5, symmetric=True)
    r, c, v = normalized_adjacency(n, r, c, v)
    ref = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    return ref, tiled_from_arrays(dataclasses.asdict(ref))


class _Guard:
    """Stand-in for ft.PreemptionGuard with a test-armed flag (signal
    handlers can only be installed from the main thread)."""

    def __init__(self, after):
        self.after = after
        self.n = 0
        self.armed = False

    def requested(self):
        return self.armed

    def cb(self, step, theta, res):
        self.n += 1
        if self.n == self.after:
            self.armed = True


def _port_store(backend, root=None, *, plan=None, write_behind=True,
                cache_bytes=1 << 18, **opts):
    if backend == "ram":
        return P.TieredStore(device="cpu")
    return P.TieredStore(backend="safs", device="cpu", backend_opts={
        "root": root, "cache_bytes": cache_bytes,
        "write_behind": write_behind, "faults": plan, "retry": FAST_RETRY,
        **opts})


def _ref_store(backend, root=None):
    if backend == "ram":
        return R.TieredStore()
    return R.TieredStore(backend="safs", backend_opts={
        "root": root, "cache_bytes": 1 << 18})


def _port_solve(tm, method, store, nev=4, **kw):
    return P.solve(P.GraphOperator(tm[1], store=store), nev, method=method,
                   max_iters=100, store=store, **kw)


def _ref_solve(tm, method, store, nev=4, **kw):
    return R.solve(R.GraphOperator(tm[0], store=store, impl="ref"), nev,
                   method=method, max_iters=100, impl="ref", store=store,
                   **kw)


# ------------------------------------------------------ snapshot format
def _tree_values():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "d": rng.standard_normal(5),
            "b": rng.standard_normal(6).astype(np.float32),
            "step": np.int32(3), "ids": np.arange(7, dtype=np.int64),
            "mask": np.array([True, False, True])}


def _ref_tree(vals):
    return {"layer": {"w": jnp.asarray(vals["w"]),
                      "b": jnp.asarray(vals["b"], jnp.bfloat16)},
            "step": jnp.asarray(vals["step"]),
            "hist": [jnp.asarray(vals["d"]), jnp.asarray(vals["ids"]),
                     {"mask": jnp.asarray(vals["mask"]), "none": None}],
            "count": 11}


def _port_tree(vals, ref_tree):
    bf16_bits = np.array(ref_tree["layer"]["b"]).view(np.uint16)
    return {"layer": {"w": torch.from_numpy(vals["w"]),
                      "b": torch.from_numpy(bf16_bits.view(np.int16))
                      .view(torch.bfloat16)},
            "step": torch.tensor(int(vals["step"]), dtype=torch.int32),
            "hist": [torch.from_numpy(vals["d"]),
                     torch.from_numpy(vals["ids"]),
                     {"mask": torch.from_numpy(vals["mask"]), "none": None}],
            "count": 11}


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return a.tobytes()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_snapshot_format_crosses_packages(tmp_path, writer):
    """Either package's `save` restores in the other, and the two write
    the same manifest (names, dtypes, shapes) and the same array bytes
    for the same tree. (JAX keeps 64-bit leaves only with x64 on.)"""
    with jax.enable_x64(True):
        _check_format_crosses(tmp_path, writer)


def _check_format_crosses(tmp_path, writer):
    vals = _tree_values()
    ref_tree = _ref_tree(vals)
    port_tree = _port_tree(vals, ref_tree)
    rck.save(str(tmp_path / "ref"), 4, ref_tree, extra={"k": 1})
    ck.save(str(tmp_path / "port"), 4, port_tree, extra={"k": 1})
    man = {w: json.load(open(tmp_path / w / "step_0000000004" /
                             ck.MANIFEST)) for w in ("ref", "port")}
    assert man["ref"] == man["port"]
    assert "bfloat16" in man["port"]["dtypes"]
    za = np.load(tmp_path / "ref" / "step_0000000004" / "arrays.npz")
    zb = np.load(tmp_path / "port" / "step_0000000004" / "arrays.npz")
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes()

    root = str(tmp_path / writer)
    if writer == "ref":
        got, extra = ck.restore(root, 4, port_tree)
        want = port_tree
    else:
        got, extra = rck.restore(root, 4, ref_tree)
        want = ref_tree
    assert extra == {"k": 1}
    names_got, leaves_got, _ = ck._flatten_with_paths(got)
    names_want, leaves_want, _ = ck._flatten_with_paths(want)
    assert names_got == names_want == man[writer]["names"]
    for a, b in zip(leaves_got, leaves_want):
        assert _bytes(a) == _bytes(b)
        assert tuple(np.shape(a)) == tuple(np.shape(b))
    assert ck._host(got["layer"]["b"])[1] == "bfloat16"
    assert got["hist"][2]["none"] is None


# ------------------------------------------------ cross-package resume
_XMETHODS = [("krylov_schur", {"tol": 1e-6}),
             ("lobpcg", {"tol": 1e-4, "seed": 3})]


@pytest.mark.disk
@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("backend", ["ram", "safs"])
@pytest.mark.parametrize("method,kw", _XMETHODS,
                         ids=[m for m, _ in _XMETHODS])
def test_resume_crosses_packages(tm, disk_tmp, method, kw, backend, writer):
    """A solve suspended in one package resumes in the other: the same
    resumed step, eigenvalues at rtol 1e-5 of the writer's own resumed
    run and equal IOStats."""
    root = os.path.join(disk_tmp, "ck")
    g = _Guard(after=2)
    if writer == "ref":
        with pytest.raises(RefSuspended) as ei:
            _ref_solve(tm, method, _ref_store(backend, os.path.join(
                disk_tmp, "w")), checkpoint=RefPolicy(root=root, guard=g),
                callback=g.cb, **kw)
    else:
        with pytest.raises(SolveSuspended) as ei:
            _port_solve(tm, method, _port_store(backend, os.path.join(
                disk_tmp, "w")), checkpoint=CheckpointPolicy(
                root=root, guard=g), callback=g.cb, **kw)
    ref = _ref_solve(tm, method, _ref_store(backend, os.path.join(
        disk_tmp, "r")), resume=root, **kw)
    port = _port_solve(tm, method, _port_store(backend, os.path.join(
        disk_tmp, "p")), resume=root, **kw)
    assert ref.converged and port.converged
    assert ref.resumed_step == port.resumed_step == ei.value.step
    np.testing.assert_allclose(np.sort(port.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=RTOL)
    assert port.n_restarts == ref.n_restarts
    assert port.io_stats == ref.io_stats


# ------------------------------------------ bit-identical continuation
_METHODS = [("krylov_schur", 4, {"tol": 1e-6}),
            ("lobpcg", 4, {"tol": 1e-5, "seed": 3})]


@pytest.mark.disk
@pytest.mark.parametrize("backend", ["ram", "safs"])
@pytest.mark.parametrize("method,nev,kw", _METHODS,
                         ids=[m[0] for m in _METHODS])
def test_resume_is_bit_identical(tm, disk_tmp, method, nev, kw, backend):
    full = _port_solve(tm, method, _port_store(backend, os.path.join(
        disk_tmp, "full")), nev, **kw)
    assert full.converged and full.resumed_step is None
    root = os.path.join(disk_tmp, "ck")
    g = _Guard(after=5)
    with pytest.raises(SolveSuspended) as ei:
        _port_solve(tm, method, _port_store(backend, os.path.join(
            disk_tmp, "s")), nev, callback=g.cb,
            checkpoint=CheckpointPolicy(root=root, every_restarts=2,
                                        guard=g), **kw)
    assert ei.value.step == 5           # preempted off the cadence
    assert ck.valid_steps(os.path.join(root, "state")) == [2, 4, 5]
    res = _port_solve(tm, method, _port_store(backend, os.path.join(
        disk_tmp, "r")), nev, resume=root, **kw)
    assert res.resumed_step == 5
    assert np.array_equal(res.eigenvalues, full.eigenvalues)
    assert np.array_equal(res.residuals, full.residuals)
    assert res.n_restarts == full.n_restarts and res.n_ops == full.n_ops


# ------------------------------------------------------ suspend / resume
@pytest.mark.parametrize("method,nev,kw", _METHODS,
                         ids=[m[0] for m in _METHODS])
def test_preemption_suspend_resume_ram(tm, tmp_path, method, nev, kw):
    """In-RAM backend: guard fires mid-solve → SolveSuspended after the
    boundary checkpoint commits → resumed solve converges to the clean
    spectrum with ≤ 1 extra step."""
    ref = _port_solve(tm, method, P.TieredStore(device="cpu"), nev, **kw)
    assert ref.converged
    g = _Guard(after=2)
    root = str(tmp_path / "ck")
    with pytest.raises(SolveSuspended) as ei:
        _port_solve(tm, method, P.TieredStore(device="cpu"), nev,
                    checkpoint=CheckpointPolicy(root=root, every_restarts=1,
                                                guard=g),
                    callback=g.cb, **kw)
    assert ei.value.root == root
    res = _port_solve(tm, method, P.TieredStore(device="cpu"), nev,
                      resume=root, **kw)
    assert res.converged
    assert res.resumed_step == ei.value.step
    np.testing.assert_allclose(np.sort(res.eigenvalues),
                               np.sort(ref.eigenvalues), rtol=RTOL)
    assert res.n_restarts <= ref.n_restarts + 1


def test_resume_rejects_other_solve_shape(tm, tmp_path):
    root = str(tmp_path / "ck")
    g = _Guard(after=1)
    with pytest.raises(SolveSuspended):
        _port_solve(tm, "krylov_schur", P.TieredStore(device="cpu"),
                    tol=1e-6, callback=g.cb,
                    checkpoint=CheckpointPolicy(root=root, guard=g))
    with pytest.raises(ValueError, match="params mismatch"):
        _port_solve(tm, "krylov_schur", P.TieredStore(device="cpu"), 5,
                    tol=1e-6, resume=root)
    with pytest.raises(ValueError, match="method"):
        _port_solve(tm, "lobpcg", P.TieredStore(device="cpu"), tol=1e-6,
                    resume=root)


def test_checkpoint_unsupported_method_rejected(tm):
    with pytest.raises(ValueError, match="checkpoint/resume"):
        P.solve(P.GraphOperator(tm[1], device="cpu"), 4, method="lanczos",
                checkpoint=CheckpointPolicy(root="/nonexistent"))


def test_resume_from_empty_root_starts_fresh(tm, tmp_path):
    """Crash before the first snapshot: the resume root holds no committed
    checkpoint, so the solve starts from scratch."""
    ref = _port_solve(tm, "krylov_schur", P.TieredStore(device="cpu"),
                      tol=1e-6)
    res = _port_solve(tm, "krylov_schur", P.TieredStore(device="cpu"),
                      tol=1e-6, resume=str(tmp_path / "never_written"))
    assert res.resumed_step is None
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=RTOL)
