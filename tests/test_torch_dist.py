"""The port's sharded layer on eight ranks, as gloo processes on the CPU,
held to the reference's tests/test_distributed.py on the same graphs.

One world of eight ranks (a (2, 2, 2) mesh, and a (2, 4, 1) mesh over the
same ranks) runs every multi-rank case once, in a script started as a
subprocess: `dist.spawn` starts the ranks with multiprocessing's "spawn",
which imports a rank function by name from the script, never from a test
module. Meanwhile the reference runs its side on its forced 8-device mesh
(another subprocess). The cases:

  * build_dspmm against the dense product (rtol/atol 1e-4, the
    reference's bar), and build_eigen_step's three invariants (1e-4);
  * h and r bit-equal on every rank, from the step and from the last
    fused expansion of a solve;
  * each rank's collective bytes equal to the analytic count;
  * DistOperator + the port's eigsh from the reference's start draw:
    eigenvalues within rtol 1e-5 of the reference's forced-mesh run;
  * the reference's pod_compressed gates over 3 restarts (last < 2e-2,
    not above twice the smallest after the first) and the compressed
    stream within 5e-3;
  * every rank's kernels at its own shapes within the float64 check's
    limits (`examples.dist_eigen_e2e.kernel_check`);
  * compressed_psum_pod bit-equal to the reference's (int8 codes and
    their int32 sum are exact);
  * a controller that raises stops its workers, and a rank that hangs
    fails spawn at its timeout.
"""
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
BS = 2                                     # the reference's e2e block
N_PAD = 640                                # padded_n(600, 4, 2)

PORT_WORLD = r'''
import sys
import numpy as np
import torch
from repro_torch.dist import (DistOperator, Mesh, build_dspmm,
                              build_eigen_step, compressed_psum_pod,
                              pack_edge_panels, padded_n,
                              pod_compressed_deviation, spawn,
                              vertex_permutation)
from repro_torch.dist.dspmm import Panel, local_shard, vector_spec
from repro_torch.examples.dist_eigen_e2e import kernel_check


def rank(mesh, draw):
    from repro_torch.core import GraphOperator, eigsh
    from repro_torch.graphs import (pack_tiles, rmat_graph, rmat_spectral,
                                    to_dense)
    out = {}
    # --- build_dspmm and build_eigen_step (test_distributed.py:12-58)
    R, M, n = 4, 2, 500
    r, c, v = rmat_graph(n, 4000, seed=11, symmetric=True)
    n_pad = padded_n(n, R, M)
    perm = vertex_permutation(n_pad, R, M)
    pc, pr, pv, e_loc = pack_edge_panels(n_pad, perm[r], perm[c], v,
                                         r_groups=R, m_groups=M)
    panel = Panel(pc=pc[mesh.g, mesh.m], pr=pr[mesh.g, mesh.m],
                  pv=pv[mesh.g, mesh.m], n_rows=n_pad // R,
                  n_cols=n_pad // M, device="cpu")
    rng = np.random.default_rng(0)
    x = np.zeros((n_pad, 4), np.float32)
    x[perm[:n]] = rng.standard_normal((n, 4)).astype(np.float32)
    vs = vector_spec(mesh)
    x_loc = torch.from_numpy(local_shard(x, vs, mesh))
    y = mesh.gather(build_dspmm(mesh, n_pad=n_pad, e_loc=e_loc, b=4)(
        panel, x_loc))
    nb_v = 3
    vb = rng.standard_normal((n_pad, nb_v * 4)).astype(np.float32)
    qv, _ = np.linalg.qr(vb)
    vstack = np.ascontiguousarray(
        qv.reshape(n_pad, nb_v, 4).transpose(1, 0, 2)).astype(np.float32)
    v_loc = torch.from_numpy(np.ascontiguousarray(
        vstack[:, mesh.rank * (n_pad // 8):(mesh.rank + 1) * (n_pad // 8)]))
    step = build_eigen_step(mesh, n_pad=n_pad, e_loc=e_loc, b=4, nb_v=nb_v)
    mesh.reset_counters()
    q_loc, h, rr = step(panel, v_loc, x_loc)
    out["step_bytes"] = dict(mesh.bytes)
    qn = mesh.gather(q_loc)
    out["h"], out["r"] = h.numpy(), rr.numpy()
    if mesh.rank == 0:
        dense = to_dense(n, r, c, v)
        out.update(y=y.numpy(), want_y=dense @ x[perm[:n]], perm=perm[:n],
                   qn=qn.numpy(), qv=qv.astype(np.float32), x=x,
                   ax=dense @ x[perm[:n]])

    # --- compressed_psum_pod on a (2, 4, 1) mesh of the same ranks
    mesh2 = Mesh((2, 4, 1), device="cpu")
    xs = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    out["psum"] = compressed_psum_pod(torch.from_numpy(xs[mesh2.pod]),
                                      mesh2).numpy()

    # --- eigsh parity, pod_compressed, compressed (test_distributed.py:93)
    r, c, v = rmat_spectral(600, 6000, seed=1)
    w_local = None
    if mesh.rank == 0:
        tm = pack_tiles(600, 600, r, c, v, block_shape=(64, 64),
                        min_block_nnz=4)
        w_local = np.sort(eigsh(GraphOperator(tm, device="cpu"), 4,
                                block_size=2, tol=1e-7,
                                max_restarts=100).eigenvalues)
        out["w_local"] = w_local
    dop = DistOperator(600, r, c, v, mesh=mesh)
    mesh.reset_counters()
    res = dop.drive(eigsh, dop, 4, block_size=2, tol=1e-7, max_restarts=100,
                    x0=draw)
    out["solve_bytes"] = dict(mesh.bytes)
    out["solve_analytic"] = dict(dop.analytic_bytes)
    out["solve_h"], out["solve_r"] = (t.numpy() for t in dop.last_hr)
    out["fused_steps"] = dop.n_fused_steps
    kc = kernel_check(dop, 1e-5)
    out["kcheck_failures"] = len(kc["failures"])
    out["kcheck_errs"], out["kcheck_plain"] = kc["errs"], kc["plain_errs"]
    out["kcheck_bound"] = kc["of_bound"]
    if res is not None:
        out["w_dist"] = np.sort(res.eigenvalues)
        out["converged"] = res.converged
    devs = pod_compressed_deviation(
        600, r, c, v, w_local if w_local is not None else np.zeros(4),
        mesh=mesh, nev=4, block_size=2, max_restarts=3, x0=draw, base=dop)
    if devs is not None:
        out["devs"] = np.asarray(devs)
    dz = DistOperator(600, r, c, v, mesh=mesh, compressed=True)
    comp = dz.drive(eigsh, dz, 4, block_size=2, tol=1e-4, max_restarts=20,
                    x0=draw)
    if comp is not None:
        out["w_comp"] = np.sort(comp.eigenvalues)
    return out


if __name__ == "__main__":
    draw = np.load(sys.argv[1])
    outs = spawn(rank, (2, 2, 2), backend="gloo", device="cpu",
                 args=(draw,), timeout=300,
                 init_method="file://" + sys.argv[3])
    flat = {}
    for k, o in enumerate(outs):
        for key, val in o.items():
            if isinstance(val, dict):
                for kind, nbytes in val.items():
                    flat[f"{k}:{key}:{kind}"] = np.asarray(nbytes)
            else:
                flat[f"{k}:{key}"] = np.asarray(val)
    np.savez(sys.argv[2], **flat)
    print("PORT_WORLD_OK")
'''

REF_WORLD = r'''
import sys, warnings
warnings.filterwarnings("ignore")
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import eigsh
from repro.dist import DistOperator
from repro.dist.compress import compressed_psum_pod
from repro.graphs import rmat_spectral
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
r, c, v = rmat_spectral(600, 6000, seed=1)
dop = DistOperator(600, r, c, v, mesh=mesh)
dist = eigsh(dop, 4, block_size=2, tol=1e-7, max_restarts=100, impl="ref")
draw = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (dop.n, 2),
                                    jnp.float32))
mesh2 = jax.make_mesh((2, 4), ("pod", "data"))
x = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
f = shard_map(lambda t: compressed_psum_pod(t[0], "pod"), mesh=mesh2,
              in_specs=P("pod", None), out_specs=P(None))
psum = np.asarray(jax.jit(f)(jnp.asarray(x)))
np.savez(sys.argv[1], w=np.sort(dist.eigenvalues), conv=dist.converged,
         draw=draw, psum=psum, perm=dop.perm)
print("REF_WORLD_OK")
'''


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, **extra)
    return env


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, run side by side: the reference's forced 8-device
    mesh and the port's eight gloo ranks (from the reference's draw,
    computed here on the CPU as the reference computes it)."""
    tmp = tmp_path_factory.mktemp("dist")
    draw = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N_PAD, BS),
                                        jnp.float32))
    np.save(tmp / "draw.npy", draw)
    (tmp / "ref.py").write_text(REF_WORLD)
    (tmp / "port.py").write_text(PORT_WORLD)
    ref = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"))
    try:
        port = subprocess.run(
            [sys.executable, str(tmp / "port.py"), str(tmp / "draw.npy"),
             str(tmp / "port.npz"), str(tmp / "rendezvous")],
            capture_output=True, text=True, env=_env(), timeout=400)
        ref_out = ref.communicate(timeout=400)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert port.returncode == 0 and "PORT_WORLD_OK" in port.stdout, (
        port.stdout[-4000:] + port.stderr[-4000:])
    assert ref.returncode == 0 and "REF_WORLD_OK" in ref_out, ref_out[-4000:]
    p = dict(np.load(tmp / "port.npz"))
    r = dict(np.load(tmp / "ref.npz"))
    np.testing.assert_array_equal(r["draw"], draw)
    return p, r


def _bytes(p, rank, key):
    pre = f"{rank}:{key}:"
    return {k[len(pre):]: int(v) for k, v in p.items() if k.startswith(pre)}


def test_dspmm_matches_dense_product(worlds):
    p, _ = worlds
    perm = p["0:perm"]
    np.testing.assert_allclose(p["0:y"][perm], p["0:want_y"], rtol=1e-4,
                               atol=1e-4)


def test_eigen_step_invariants(worlds):
    p, _ = worlds
    qn, qv, h, rr = p["0:qn"], p["0:qv"], p["0:h"], p["0:r"]
    assert np.abs(qn.T @ qn - np.eye(4)).max() < 1e-4
    assert np.abs(qv.T @ qn).max() < 1e-4
    ax = np.zeros_like(p["0:x"])
    ax[p["0:perm"]] = p["0:ax"]
    recon = qv @ h + qn @ rr
    assert np.abs(ax - recon).max() / np.abs(ax).max() < 1e-4


def test_h_and_r_bit_equal_across_ranks(worlds):
    p, _ = worlds
    for k in range(1, 8):
        for key in ("h", "r", "solve_h", "solve_r"):
            np.testing.assert_array_equal(p[f"{k}:{key}"], p[f"0:{key}"])


def test_collective_bytes_equal_analytic(worlds):
    """Per rank, one step over (R, M) = (4, 2), b = 4, nb_v = 3 at n_pad =
    512: n_pad/M·b·4 gathered, n_pad/R·b·4 reduced, (2·nb_v·b² + 2·b²)·4
    all-reduced; and a whole solve equal to the operator's own count."""
    p, _ = worlds
    n_pad, b, nb_v = 512, 4, 3
    want = {"all_gather": n_pad // 2 * b * 4,
            "reduce_scatter": n_pad // 4 * b * 4,
            "all_reduce": (2 * nb_v * b * b + 2 * b * b) * 4}
    for k in range(8):
        got = _bytes(p, k, "step_bytes")
        assert {kind: got.get(kind, 0) for kind in want} == want, (k, got)
        solve = _bytes(p, k, "solve_bytes")
        analytic = _bytes(p, k, "solve_analytic")
        assert analytic["all_gather"] > 0
        assert {kind: solve[kind] for kind in analytic} == analytic


def test_spectrum_matches_reference_forced_mesh(worlds):
    p, r = worlds
    assert bool(r["conv"]) and bool(p["0:converged"])
    assert int(p["0:fused_steps"]) > 0
    np.testing.assert_allclose(p["0:w_dist"], r["w"], rtol=1e-5)
    np.testing.assert_allclose(p["0:w_dist"], p["0:w_local"], rtol=1e-5)


def test_pod_compressed_and_compressed_gates(worlds):
    p, _ = worlds
    devs = p["0:devs"]
    assert len(devs) >= 2, devs
    assert devs[-1] < 2e-2, devs
    assert devs[-1] <= 2.0 * devs[1:].min() + 1e-12, devs
    dev_z = np.abs(np.sort(np.abs(p["0:w_comp"]))
                   - np.sort(np.abs(p["0:w_local"]))).max()
    assert dev_z < 5e-3, dev_z


def test_kernel_check_at_each_ranks_shapes(worlds):
    """Every rank's SpMM over its panel image, and gram and tsgemm at its
    (n_pad/8, b) shard of the subspace stack, within the float64 check's
    limits (`dist_eigen_e2e.kernel_check`; on the CPU both sides of each
    are the plain versions)."""
    p, _ = worlds
    want = {"spmm k2", "gram 80x2", "tsgemm 80x2"}
    for k in range(8):
        assert int(p[f"{k}:kcheck_failures"]) == 0, k
        errs = _bytes(p, k, "kcheck_errs")
        assert set(errs) == want, errs
        for key in want:
            assert float(p[f"{k}:kcheck_errs:{key}"]) <= 1e-5
            assert float(p[f"{k}:kcheck_plain:{key}"]) <= 1e-5
        for name in ("kernel", "plain"):
            assert 0 <= float(p[f"{k}:kcheck_bound:{name}"]) <= 1


def test_compressed_psum_pod_bit_equal_reference(worlds):
    p, r = worlds
    for k in range(8):
        np.testing.assert_array_equal(p[f"{k}:psum"], r["psum"])


FAILURES = r'''
import multiprocessing, sys, time
import torch
from repro_torch.dist import DistOperator, spawn
from repro_torch.graphs import rmat_graph


def controller_raises(mesh):
    r, c, v = rmat_graph(64, 400, seed=1, symmetric=True)
    op = DistOperator(64, r, c, v, mesh=mesh)

    def fn():
        op.matmat(torch.ones(op.n, 2))
        raise ValueError("controller fails")
    return op.drive(fn)


def rank_hangs(mesh):
    if mesh.rank == 1:
        time.sleep(600)
    return mesh.rank


if __name__ == "__main__":
    target = {"raise": controller_raises, "hang": rank_hangs}[sys.argv[1]]
    t0 = time.monotonic()
    try:
        spawn(target, (1, 1, 2), backend="gloo", device="cpu",
              timeout=float(sys.argv[2]),
              init_method="file://" + sys.argv[3])
    except (RuntimeError, TimeoutError) as e:
        print("RAISED", type(e).__name__, str(e).splitlines()[0])
        print("CAUSE", "controller fails" in str(e))
        print("ALIVE", len(multiprocessing.active_children()))
        print("SECONDS", time.monotonic() - t0)
'''


@pytest.mark.parametrize("case,timeout,error", [
    ("raise", 120, r"RuntimeError spawn: rank 0 failed"),
    # rank 0 may still be starting under load when the deadline passes
    ("hang", 20, r"TimeoutError spawn: ranks \[(0, )?1\] did not finish")],
    ids=["raise", "hang"])
def test_failed_or_hung_rank_fails_spawn(tmp_path, case, timeout, error):
    """A controller that raises sends shutdown from drive's finally, so
    its worker returns and spawn raises the controller's error at once; a
    rank that hangs makes spawn raise at its timeout, while the rank that
    finished waits at the closing barrier (it does not tear the group
    down under its peer). Either way no rank process is left."""
    (tmp_path / "f.py").write_text(FAILURES)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, str(tmp_path / "f.py"), case, str(timeout),
         str(tmp_path / "rendezvous")],
        capture_output=True, text=True, env=_env(), timeout=300)
    wall = time.monotonic() - t0
    assert re.search(f"RAISED {error}", out.stdout), (out.stdout
                                                    + out.stderr[-3000:])
    assert "ALIVE 0" in out.stdout, out.stdout
    assert wall < timeout + 60, wall
    if case == "raise":
        assert "CAUSE True" in out.stdout, out.stdout
        seconds = float(out.stdout.split("SECONDS")[1])
        assert seconds < 60, seconds
