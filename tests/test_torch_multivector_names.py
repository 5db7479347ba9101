"""MultiVector auto-names never take a live `mv<N>` name.

A resumed solve rebuilds its MultiVectors under their checkpointed names
(`mv<N>`); the reference raises its class counter past any such name it
is given, so a later auto-named MultiVector in the same store cannot take
a live name and overwrite its blocks. The port must do the same, also in
a fresh process whose counter starts at 0.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointPolicy, SolveSuspended
from repro_torch.core import GraphOperator, MultiVector, TieredStore, solve
from repro_torch.graphs import normalized_adjacency, pack_tiles, rmat_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 400


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few
    cores, and these solves run their own threads (and the reference's)
    beside torch's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_explicit_mv_name_raises_the_auto_counter(monkeypatch):
    """The re-anchor's scratch case: `mv1` given a block, then an
    auto-named MultiVector in the same store (counter at 0, as in a fresh
    process)."""
    monkeypatch.setattr(MultiVector, "_counter", 0)
    store = TieredStore(device="cpu")
    first = MultiVector(store, 256, name="mv1")
    blk = np.random.default_rng(0).standard_normal((256, 4)).astype(
        np.float32)
    first.append_block(blk)
    second = MultiVector(store, 256)
    assert second.name != "mv1"
    second.append_block(np.zeros((256, 4), np.float32))
    np.testing.assert_array_equal(first.block(0).numpy(), blk)
    # a name of another form leaves the counter alone
    MultiVector(store, 256, name="V")
    assert MultiVector(store, 256).name == f"mv{int(second.name[2:]) + 1}"


class _Guard:
    """Stand-in for ft.PreemptionGuard, armed after `after` restarts."""

    def __init__(self, after):
        self.after, self.n, self.armed = after, 0, False

    def requested(self):
        return self.armed

    def cb(self, step, theta, res):
        self.n += 1
        self.armed = self.n >= self.after


_RESUME = textwrap.dedent("""
    import json, sys
    import numpy as np
    from repro_torch.core import (GraphOperator, MultiVector, TieredStore,
                                  solve)
    from repro_torch.graphs import normalized_adjacency, pack_tiles, rmat_graph

    names = []
    init = MultiVector.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        names.append(self.name)

    MultiVector.__init__ = recording_init
    root, n = sys.argv[1], int(sys.argv[2])
    r, c, v = normalized_adjacency(n, *rmat_graph(n, 4000, seed=5,
                                                  symmetric=True))
    tm = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    store = TieredStore(device="cpu")
    live = MultiVector(store, tm.shape[0])
    blk = np.random.default_rng(1).standard_normal((tm.shape[0], 4))
    live.append_block(blk.astype(np.float32))
    extra = []

    def cb(step, theta, res):     # auto-named MultiVectors mid-resume
        mv = MultiVector(store, tm.shape[0])
        mv.append_block(np.full((tm.shape[0], 4), step, np.float32))
        extra.append(mv)

    res = solve(GraphOperator(tm, store=store), 4, method="krylov_schur",
                max_iters=100, store=store, tol=1e-6, resume=root,
                callback=cb)
    intact = bool(np.array_equal(live.block(0).numpy(),
                                 blk.astype(np.float32)))
    extra_ok = all(bool((mv.block(0).numpy() == mv.block(0).numpy()[0, 0])
                        .all()) for mv in extra)
    print(json.dumps({"names": names, "live": live.name, "intact": intact,
                      "extra_ok": extra_ok, "converged": bool(res.converged),
                      "resumed_step": res.resumed_step,
                      "eigenvalues": sorted(map(float, res.eigenvalues))}))
""")


def test_resume_in_a_fresh_process_beside_a_live_multivector(tmp_path,
                                                            monkeypatch):
    """A Krylov–Schur solve suspended after restart 2 (its MultiVectors
    named from a counter at 0, as a fresh process names them), then
    resumed in a subprocess into a store that already holds a live
    auto-named MultiVector, with more auto-named ones made at every
    restart: no name is used twice, every block stays intact, and the
    resumed spectrum is the uninterrupted solve's."""
    r, c, v = normalized_adjacency(N, *rmat_graph(N, 4000, seed=5,
                                                  symmetric=True))
    tm = pack_tiles(N, N, r, c, v, block_shape=(64, 64), min_block_nnz=4)

    def run(**kw):
        store = TieredStore(device="cpu")
        return solve(GraphOperator(tm, store=store), 4,
                     method="krylov_schur", max_iters=100, store=store,
                     tol=1e-6, **kw)

    ref = run()
    monkeypatch.setattr(MultiVector, "_counter", 0)
    root = str(tmp_path / "ck")
    g = _Guard(after=2)
    with pytest.raises(SolveSuspended):
        run(checkpoint=CheckpointPolicy(root=root, every_restarts=1,
                                        guard=g), callback=g.cb)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _RESUME, root, str(N)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["live"] == "mv1"               # the fresh process's first
    assert len(got["names"]) == len(set(got["names"])), got["names"]
    assert got["intact"] and got["extra_ok"]
    assert got["converged"] and got["resumed_step"] is not None
    np.testing.assert_allclose(got["eigenvalues"], np.sort(ref.eigenvalues),
                               rtol=1e-5)
