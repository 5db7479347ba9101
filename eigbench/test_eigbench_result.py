"""The result line: its keys, their order, and no line without a card."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from eigbench.harness import cell as runner
from eigbench.harness.manifest import load_cell

REPO = Path(__file__).resolve().parents[1]


def test_result_keys_with_the_checks_last(tiny_root):
    cell = load_cell("kron21-ks.nev8", tiny_root)
    out = runner.run_cell(cell, 2 ** 40 + 3, 0.2, False, torch.device("cpu"),
                          time.perf_counter())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == set(cell.end_to_end)
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.loads(json.dumps(out))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "eigbench/run.py", "--workload",
                          "kron21-ks.nev8", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
