"""pytest settings of the benchmark's own tests (`test_eigbench_*.py`).

They run on the CPU at tiny sizes; a test that needs the card carries the
`gpu` marker and skips inside its fixture when there is none. The
`tiny_root` fixture copies the benchmark's data files into a temporary
folder with every configuration cut to 2^scale vertices.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for path in (str(HERE.parent), str(HERE.parent / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips inside the test when "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's card tests run on the chip")
    return torch.device("cuda", 0)


def make_tiny_root(dest: Path, scale: int = 10) -> Path:
    """The benchmark's configs, traffic, cells and metrics under `dest`,
    every configuration cut to 2^scale vertices."""
    for folder in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(HERE / folder, dest / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for path in (dest / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["scale"] = scale
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "bench")
