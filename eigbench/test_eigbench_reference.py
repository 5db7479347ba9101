"""The plain reference against numpy's dense eigensolvers at a tiny size,
and its judgement of answers."""
import numpy as np
import pytest
import torch

from eigbench.gen import kronecker
from eigbench.reference import eigen as ref

SPEC = {"generator": "kronecker", "initiator": [0.57, 0.19, 0.19],
        "symmetric": True, "values": "normalized", "scale": 9,
        "edge_factor": 8}


def _dense(g):
    a = np.zeros((g.n, g.n))
    a[g.rows, g.cols] = g.vals
    return a


@pytest.mark.parametrize("component", ["all", "largest"])
def test_eigenvalues_against_dense_eigvalsh(component):
    g = kronecker.make_graph(SPEC | {"component": component}, 21, "cpu")
    op = ref.PlainOperator(g.n, g.rows, g.cols, g.vals, "cpu")
    theta, res, _ = ref.reference_values(op, 8, "eig", "cpu", seed=3)
    lam = np.linalg.eigvalsh(_dense(g))
    want = lam[np.argsort(-np.abs(lam), kind="stable")][:8]
    np.testing.assert_allclose(np.sort(np.abs(theta)),
                               np.sort(np.abs(want)), atol=1e-9)
    assert res <= ref.REF_TOL


def test_singular_values_against_dense_svd():
    g = kronecker.make_graph(SPEC | {"symmetric": False, "values": "ones"},
                             22, "cpu")
    op = ref.PlainOperator(g.n, g.rows, g.cols, g.vals, "cpu", t=True)
    sigma, res, _ = ref.reference_values(op, 8, "svd", "cpu", seed=4)
    want = np.linalg.svd(_dense(g), compute_uv=False)[:8]
    np.testing.assert_allclose(sigma, want, rtol=1e-9)


def test_judge_exact_and_perturbed_answers():
    g = kronecker.make_graph(SPEC, 23, "cpu")
    op = ref.PlainOperator(g.n, g.rows, g.cols, g.vals, "cpu")
    lam, vec = np.linalg.eigh(_dense(g))
    top = np.argsort(-np.abs(lam), kind="stable")[:8]
    theta, x = lam[top], torch.as_tensor(vec[:, top])
    good = ref.judge_eig(op, theta, x, theta, "LM")
    assert max(good.values()) < 1e-12
    bad = ref.judge_eig(op, theta + 1e-3, x, theta, "LM")
    assert bad["value_gap"] > 9e-4 and bad["residual"] > 9e-4
    skew = x.clone()
    skew[:, 0] += 1e-3 * x[:, 1]
    assert ref.judge_eig(op, theta, skew, theta, "LM")["orthogonality"] > 9e-4


def test_control_in_bfloat16_is_far_from_float64():
    g = kronecker.make_graph(SPEC | {"symmetric": False, "values": "ones"},
                             24, "cpu")
    op = ref.PlainOperator(g.n, g.rows, g.cols, g.vals, "cpu", t=True)
    want, _, _ = ref.reference_values(op, 8, "svd", "cpu", seed=5)
    x0 = kronecker.start_block(g.n, 2, 24, kronecker.solve_stream(0), "cpu")
    sigma, u = ref.control_answer(op, 8, "svd", x0)
    got = ref.judge_svd(op, sigma, u, want)
    assert got["residual"] > 1e-4
