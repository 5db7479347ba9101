"""On the card (skipped without one): a whole run at a small size through
the program's kernels, untraced and traced."""
import time

import pytest

from eigbench.gen import kronecker
from eigbench.harness import cell as runner
from eigbench.harness.manifest import load_cell


@pytest.mark.gpu
def test_generator_on_the_card_follows_the_seed(card):
    spec = {"generator": "kronecker", "initiator": [0.57, 0.19, 0.19],
            "symmetric": True, "values": "normalized", "scale": 14,
            "edge_factor": 8}
    a = kronecker.make_graph(spec, 2 ** 33 + 1, card)
    b = kronecker.make_graph(spec, 2 ** 33 + 1, card)
    assert (a.rows == b.rows).all() and (a.vals == b.vals).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kron21-ks.nev8", "kron21-svd.nsv8"])
def test_small_run_on_the_card(card, tiny_root, name):
    cell = load_cell(name, tiny_root)
    out = runner.run_cell(cell, 77, 1.0, False, card, time.perf_counter())
    assert out["correct"], out["checks"]
    traced = runner.run_cell(cell, 78, 1.0, True, card, time.perf_counter())
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == set(cell.per_layer)
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    for name, metric in traced["metrics"].items():
        if metric["unit"] == "%":
            assert 0 < metric["value"] <= 105, (name, metric)
