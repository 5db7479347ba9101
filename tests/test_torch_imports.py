"""The PyTorch port stands alone: importing it loads neither JAX, nor
ml_dtypes (JAX's numpy types; the card's machine has neither), nor any
module of the JAX package, and chip_smoke.py imports none of them either;
its entry points never carry on on the CPU when no device was asked for
and there is no card."""
import os
import pkgutil
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")


def _port_modules():
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_import_loads_no_jax_and_no_reference_module():
    mods = _port_modules()
    for m in ("repro_torch.kernels.ops", "repro_torch.convert",
              "repro_torch.kernels.flashattn", "repro_torch.configs",
              "repro_torch.models", "repro_torch.models.transformer",
              "repro_torch.models.steps", "repro_torch.safs.faults",
              "repro_torch.safs.pagefile", "repro_torch.safs.cache",
              "repro_torch.safs.prefetch", "repro_torch.safs.backend",
              "repro_torch.safs.scrub", "repro_torch.graphs.gio",
              "repro_torch.examples", "repro_torch.examples.ooc_lanczos"):
        assert m in mods, m
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro.")
                     or m == "triton" or m.startswith("triton.")
                     or m == "ml_dtypes" or m.startswith("ml_dtypes."))
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


_FORBIDDEN = [re.compile(p) for p in (
    r"^\s*import\s+jax\b", r"^\s*from\s+jax\b",
    r"^\s*import\s+ml_dtypes\b", r"^\s*from\s+ml_dtypes\b",
    r"^\s*import\s+repro(\.|\s|$|,)", r"^\s*from\s+repro(\.|\s)")]


def test_sources_import_no_jax_and_no_reference_module():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            for ln, line in enumerate(fh, 1):
                if any(p.search(line) for p in _FORBIDDEN):
                    offenders.append(f"{path}:{ln}: {line.strip()}")
    assert not offenders, offenders


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    from repro_torch.core import DenseOperator, GraphOperator, TieredStore
    from repro_torch.core import solve
    from repro_torch.graphs import pack_tiles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TieredStore()
    with pytest.raises(RuntimeError, match="CUDA"):
        TieredStore(backend="safs", backend_opts={"root": os.devnull})
    r = np.array([0, 1], np.int32)
    c = np.array([1, 0], np.int32)
    v = np.ones(2, np.float32)
    tm = pack_tiles(8, 8, r, c, v, block_shape=(8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphOperator(tm)
    # an operator built for the CPU is the caller asking for the CPU; an
    # operator with no device of its own gets a store that raises
    op = DenseOperator(np.eye(8, dtype=np.float32), device="cpu")

    class NoDevice:
        n = 8

        def matmat(self, x):
            return op.matmat(x)

    with pytest.raises(RuntimeError, match="CUDA"):
        solve(NoDevice(), 2, block_size=2)
    assert TieredStore(device="cpu").device.type == "cpu"


def test_model_entry_points_without_device_raise_without_cuda(monkeypatch):
    from repro_torch import configs
    from repro_torch.convert import params_from_arrays
    from repro_torch.models import steps, transformer as tf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced("yi-9b")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init_model(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_arrays({"w": np.zeros(2, np.float32)})
    params = tf.init_model(0, cfg, device="cpu")   # the caller asks
    tokens = np.zeros((1, 4), np.int32)            # no tensor: no device
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.prefill_with_cache(params, cfg, tokens)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.logits_fn(params, cfg, tokens)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.build_prefill_step(cfg)(params, {"tokens": tokens})
    logits, cache = tf.prefill_with_cache(params, cfg, tokens, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.decode_step(params, cfg, cache, tokens[:, :1], 4)
    # CPU tensors are the caller asking for the CPU
    logits, cache = tf.prefill_with_cache(params, cfg,
                                          torch.from_numpy(tokens),
                                          cache_len=5)
    out, _ = steps.build_decode_step(cfg)(params, cache,
                                          torch.zeros((1, 1), dtype=torch.int32),
                                          4)
    assert logits.device.type == out.device.type == "cpu"


def test_ooc_lanczos_example_runs_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.examples.ooc_lanczos --device cpu` at a small
    size: SAFS and RAM spectra agree, and what is not ported raises."""
    from repro_torch.examples import ooc_lanczos
    ooc_lanczos.main(["--n", "600", "--nnz", "5000", "--nev", "4",
                      "--device", "cpu", "--root", str(tmp_path / "p"),
                      "--trace", str(tmp_path / "t.jsonl")])
    out = capsys.readouterr().out
    assert "safs backend matches ram backend to rtol 1e-5" in out
    assert "physical disk I/O" in out and (tmp_path / "t.jsonl").exists()
    with pytest.raises(NotImplementedError, match="item 3"):
        ooc_lanczos.main(["--solver", "lanczos", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 4"):
        ooc_lanczos.main(["--checkpoint", str(tmp_path), "--device", "cpu"])
