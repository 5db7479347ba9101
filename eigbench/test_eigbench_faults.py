"""`correct` comes out false for the control and for faults planted under
the timed path, at a tiny size on the CPU: the harness's look for a card
is skipped and the rest of a run is driven as on the card."""
import json
import time

import numpy as np
import pytest
import torch

from eigbench.gen import kronecker
from eigbench.harness import cell as runner
from eigbench.harness.manifest import load_cell
from eigbench.harness.system import Answer
from eigbench.reference import eigen as ref


def _run(cell, seed=5, **kw):
    return runner.run_cell(cell, seed, 0.3, False, torch.device("cpu"),
                           time.perf_counter(), **kw)


def test_sound_runs_are_correct(tiny_root):
    for name in ("kron21-ks.nev8", "kron21-svd.nsv8"):
        out = _run(load_cell(name, tiny_root))
        assert out["correct"], (name, out["checks"])
        assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("name", ["kron21-ks.nev8", "kron21-ks.nb32",
                                  "kron21-svd.nsv8"])
def test_control_reference_in_bfloat16_is_not_correct(tiny_root, name):
    """A control: the plain reference computed in bfloat16 in the
    program's place, from the solves' start blocks. It is the control of
    `kron21-svd`, whose 0/1 entries the program's bf16 image holds
    exactly."""
    cell = load_cell(name, tiny_root)
    g = runner.make_graph(cell.config, "cpu")
    kind, b = cell.config["kind"], int(cell.traffic["block_size"])
    op = ref.PlainOperator(g.n, g.rows, g.cols, g.vals, "cpu",
                           t=kind == "svd")
    answers = []
    for i in range(2):
        x0 = kronecker.start_block(g.n, b, 9, kronecker.solve_stream(i), "cpu")
        vals, vecs = ref.control_answer(op, int(cell.traffic["nev"]), kind,
                                        x0)
        answers.append(Answer(i, 0.0, vals, vecs.float(), True, 0, 0))
    checks, failed, correct = runner.judge(cell, g, answers, "cpu", 9)
    assert not correct and failed == {0, 1}, checks


@pytest.mark.parametrize("name", ["kron21-ks.nev8", "kron21-ks.nb32"])
def test_control_program_bf16_image_is_not_correct(tiny_root, name):
    """The control of the `kron21-ks` cells: the program over its own
    bf16 image (`GraphOperator.astype`), through a whole run."""
    path = tiny_root / "configs" / "kron21-ks.json"
    cfg = json.loads(path.read_text())
    cfg["image"]["dtype"] = "bfloat16"
    path.write_text(json.dumps(cfg))
    out = _run(load_cell(name, tiny_root))
    assert not out["correct"] and out["failed"] == out["attempted"], \
        out["checks"]


def _no_coo(rows, cols, vals, x, n):
    return torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)


def _half_rows(spmm):
    def run(*a, **kw):
        y = spmm(*a, **kw)
        y[y.shape[0] // 2:] = 0
        return y
    return run


def _unchanged(v, w, impl="auto", fused=True):
    b = w.shape[1]
    return w, torch.zeros((v.ncols, b), dtype=w.dtype), torch.eye(b)


def _altered(solve):
    def run(*a, **kw):
        res = solve(*a, **kw)
        res.eigenvalues[0] *= 1 + 1e-3
        return res
    return run


@pytest.mark.parametrize("fault", ["coo_path_left_out", "half_the_rows",
                                   "step_returns_state_unchanged",
                                   "answer_altered"])
def test_faults_are_not_correct(tiny_root, monkeypatch, fault):
    import repro_torch.core as core
    from repro_torch.core import krylov_schur, operator
    from repro_torch.kernels import ops
    if fault == "coo_path_left_out":
        monkeypatch.setattr(operator, "coo_spmm_ref", _no_coo)
    elif fault == "half_the_rows":
        monkeypatch.setattr(ops, "spmm_blocks", _half_rows(ops.spmm_blocks))
    elif fault == "step_returns_state_unchanged":
        monkeypatch.setattr(krylov_schur, "bcgs2", _unchanged)
    else:
        monkeypatch.setattr(core, "solve", _altered(core.solve))
    with np.errstate(all="ignore"):
        out = _run(load_cell("kron21-ks.nev8", tiny_root))
    assert not out["correct"], out["checks"]
