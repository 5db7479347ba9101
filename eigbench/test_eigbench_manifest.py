"""The harness finds cells, configurations, traffic mixes and metrics as
files by name, and BENCHMARK.json agrees with them."""
import json
import time

import numpy as np
import pytest
import torch

from eigbench.harness import cell as runner
from eigbench.harness.manifest import (ROOT, check_name, load_cell,
                                       load_metric)

REPO = ROOT.parent


def test_a_new_cell_config_and_metric_run_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric
    added as new files only, and the harness runs them by name."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "workloads").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.loads((ROOT / "configs" / "kron21-ks.json").read_text())
    cfg.update(name="kron9-ks", scale=9, edge_factor=6)
    (tmp_path / "configs" / "kron9-ks.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "nev4.json").write_text(json.dumps(
        {"clients": 1, "loop": "closed", "nev": 4, "block_size": 2,
         "num_blocks": 8, "start_pool": 4, "trace_solves": 1}))
    (tmp_path / "workloads" / "kron9-ks.nev4.json").write_text(json.dumps(
        {"config": "kron9-ks", "traffic": "nev4", "chips": 1, "why": "test",
         "end_to_end": ["setup_s", "solve_s"],
         "per_layer": ["solves_seen"],
         "limits": {"value_gap": 1e-4, "residual": 1e-4,
                    "orthogonality": 1e-4, "reference_residual": 1e-8}}))
    (tmp_path / "metrics" / "solves_seen.py").write_text(
        'UNIT, BETTER, SOURCE = "count", "higher", "program_counter"\n'
        'LAYER, MOVES = "driver", "solve_s"\n'
        "def read(data):\n    return len(data.answers)\n")
    cell = load_cell("kron9-ks.nev4", tmp_path)
    assert cell.traffic["nev"] == 4 and cell.config["scale"] == 9
    out = runner.run_cell(cell, 7, 0.2, False, torch.device("cpu"),
                          time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "solve_s"}
    data = runner.LayerData(n=512, answers=[object()] * 3, images={},
                            matmat=[])
    assert runner.per_layer(cell, data) == {
        "solves_seen": {"value": 3.0, "unit": "count"}}


@pytest.mark.parametrize("change", [
    {"image": {"resident": False}}, {"store": {"backend": "safs"}},
    {"store": {"policy": "newest block on the card"}},
    {"solver": {"stream_image": True}}])
def test_a_deployment_the_harness_does_not_perform_is_refused(change):
    from eigbench.gen import kronecker
    from eigbench.harness.system import System
    cfg = json.loads((ROOT / "configs" / "kron21-ks.json").read_text())
    for key, part in change.items():
        cfg[key] = cfg[key] | part
    traffic = json.loads((ROOT / "traffic" / "nev8.json").read_text())
    g = kronecker.Graph(64, *(np.zeros(0, t) for t in ("int32", "int32",
                                                        "float32")))
    with pytest.raises(ValueError, match="implemented"):
        System(cfg, traffic, g, "cpu")


def test_names_refuse_paths():
    for bad in ("../x", "a/b", "", ".hidden/..", "x" * 65, "a b"):
        with pytest.raises(ValueError):
            check_name(bad, "cell")
    assert check_name("kron21-ks.nev8", "cell") == "kron21-ks.nev8"
    with pytest.raises(FileNotFoundError):
        load_cell("no-such-cell")


def test_benchmark_json_matches_the_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "eigbench/run.py"]
    assert bench["paths"] == ["eigbench"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert w["config"] in configs and cell.config["name"] == w["config"]
        assert cell.chips == w["chips"] and cell.why == w["why"]
        assert json.loads((ROOT / "workloads" / f"{w['name']}.json")
                          .read_text())["traffic"] == w["traffic"]
        for m in cell.end_to_end:
            assert w["name"] in e2e[m].get("workloads", [w["name"]])
        for m in cell.per_layer:
            assert w["name"] in per_layer[m]["workloads"]
    for name, m in per_layer.items():
        mod = load_metric(name)
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["unit"], m["better"], m["source"], m["layer"], m["moves"])


def test_real_cells_load():
    for path in sorted((ROOT / "workloads").glob("*.json")):
        cell = load_cell(path.stem)
        assert cell.chips == 1 and len(cell.why) <= 200
        for name in cell.per_layer:
            assert callable(load_metric(name).read)
