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
              "repro_torch.models.steps", "repro_torch.models.moe",
              "repro_torch.models.ssm", "repro_torch.models.rglru",
              "repro_torch.configs.flasheigen",
              "repro_torch.configs.grok_1_314b",
              "repro_torch.configs.arctic_480b",
              "repro_torch.configs.hubert_xlarge",
              "repro_torch.configs.llama_3_2_vision_90b",
              "repro_torch.configs.qwen2_1_5b",
              "repro_torch.configs.h2o_danube_3_4b",
              "repro_torch.configs.mistral_large_123b",
              "repro_torch.configs.recurrentgemma_2b",
              "repro_torch.configs.mamba2_780m", "repro_torch.safs.faults",
              "repro_torch.safs.pagefile", "repro_torch.safs.cache",
              "repro_torch.safs.prefetch", "repro_torch.safs.backend",
              "repro_torch.safs.scrub", "repro_torch.graphs.gio",
              "repro_torch.examples", "repro_torch.examples.ooc_lanczos",
              "repro_torch.examples.spectral_cluster",
              "repro_torch.core.lanczos", "repro_torch.core.lobpcg",
              "repro_torch.core.svd", "repro_torch.benchmarks",
              "repro_torch.benchmarks.bench_eigen", "repro_torch.ckpt",
              "repro_torch.ckpt.checkpoint", "repro_torch.ckpt.solver",
              "repro_torch.ft", "repro_torch.ft.preemption",
              "repro_torch.obs.metrics", "repro_torch.obs.progress",
              "repro_torch.obs.report", "repro_torch.graphs.partition",
              "repro_torch.examples.quickstart",
              "repro_torch.benchmarks.bench_spmm",
              "repro_torch.benchmarks.bench_tasops",
              "repro_torch.benchmarks.bench_subspace_io",
              "repro_torch.benchmarks.bench_safs",
              "repro_torch.benchmarks.run", "repro_torch.serve",
              "repro_torch.serve.arbiter", "repro_torch.serve.session",
              "repro_torch.serve.scheduler", "repro_torch.serve.api",
              "repro_torch.serve.paged_kv", "repro_torch.launch",
              "repro_torch.launch.serve", "repro_torch.dist",
              "repro_torch.dist.layout", "repro_torch.dist.comm",
              "repro_torch.dist.compress", "repro_torch.dist.dspmm",
              "repro_torch.dist.dist_operator",
              "repro_torch.examples.dist_eigen_e2e",
              "repro_torch.benchmarks.bench_dist_e2e",
              "repro_torch.data", "repro_torch.data.pipeline",
              "repro_torch.optim", "repro_torch.optim.adamw",
              "repro_torch.optim.schedule", "repro_torch.ft.straggler",
              "repro_torch.ft.coordinator", "repro_torch.train",
              "repro_torch.train.trainer", "repro_torch.launch.train",
              "repro_torch.examples.train_lm"):
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
    for mod in ("serve/arbiter.py", "serve/session.py", "serve/scheduler.py",
                "serve/api.py", "serve/paged_kv.py", "serve/__init__.py",
                "launch/serve.py", "launch/__init__.py", "dist/layout.py",
                "dist/comm.py", "dist/compress.py", "dist/dspmm.py",
                "dist/dist_operator.py", "dist/__init__.py",
                "examples/dist_eigen_e2e.py",
                "benchmarks/bench_dist_e2e.py"):
        assert os.path.join(PORT, mod) in paths, mod
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
    # a MultiVector that builds its own store, and the ladders
    from repro_torch.benchmarks import (bench_dist_e2e, bench_safs,
                                        bench_spmm, bench_subspace_io,
                                        bench_tasops)
    from repro_torch.examples import dist_eigen_e2e
    from repro_torch.core import MultiVector
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiVector(None, 8)
    assert MultiVector(None, 8, device="cpu").store.device.type == "cpu"
    for bench in (bench_spmm, bench_tasops, bench_subspace_io, bench_safs,
                  bench_dist_e2e):
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.collect(smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        dist_eigen_e2e.main(["--ranks", "1", "--n", "100", "--nnz", "400"])


def test_serve_entry_points_without_device_raise_without_cuda(monkeypatch,
                                                             tmp_path):
    """The service, the paged KV cache and the serve CLI run on the card
    unless asked for the CPU."""
    from repro_torch.launch import serve as cli
    from repro_torch.serve import PagedConfig, PagedKVCache, build_service
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_service()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_service(backend="safs", root=os.devnull)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(PagedConfig())
    ck = ["--ckpt-root", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--demo"] + ck)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--demo", "--device", "cuda"] + ck)
    svc = build_service(device="cpu")
    assert svc.store.device.type == "cpu"
    svc.close()
    assert PagedKVCache(PagedConfig(), device="cpu").store.device.type == \
        "cpu"


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


def test_training_entry_points_without_device_raise_without_cuda(
        monkeypatch, tmp_path):
    """The trainer, its launcher (cuda by default), the example and
    init_all run nowhere unless the caller names the CPU."""
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as launch_train
    from repro_torch.models import steps
    from repro_torch.train import TrainConfig, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.reduced("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.init_all(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, TrainConfig(steps=1, ckpt_dir=str(tmp_path)),
              DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                         global_batch=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps",
                           "1", "--ckpt-dir", str(tmp_path / "l")])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "e")])
    params, opt = steps.init_all(0, cfg, device="cpu")
    batch = {"tokens": np.zeros((2, 8), np.int32),
             "targets": np.zeros((2, 8), np.int32)}
    with pytest.raises(RuntimeError, match="CUDA"):   # arrays: no device
        steps.build_train_step(cfg)(params, opt, batch)
    _, _, m = steps.build_train_step(cfg, device="cpu")(params, opt, batch)
    assert m["loss"].device.type == "cpu"


def test_frontend_entry_points_without_device_raise_without_cuda(
        monkeypatch):
    """Audio frames and patch embeddings given as arrays run nowhere
    unless the caller names the CPU; CPU tensors are that request."""
    from repro_torch import configs
    from repro_torch.models import steps, transformer as tf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    audio = configs.reduced("hubert-xlarge")
    frames = np.zeros((1, 4, audio.d_model), np.float32)
    params = tf.init_model(0, audio, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.logits_fn(params, audio, frames)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.build_prefill_step(audio)(params, {"frames": frames})
    assert tf.logits_fn(params, audio, torch.from_numpy(frames)).device.type \
        == "cpu"
    vlm = configs.reduced("llama-3.2-vision-90b")
    params = tf.init_model(0, vlm, device="cpu")
    tokens = np.zeros((1, 4), np.int32)
    patches = np.zeros((1, vlm.n_frontend_tokens, vlm.d_model), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.prefill_with_cache(params, vlm, tokens, encoder=patches)
    logits, cache = tf.prefill_with_cache(params, vlm,
                                          torch.from_numpy(tokens),
                                          encoder=patches, cache_len=5)
    assert logits.device.type == cache["stack"]["l4"]["ck"].device.type \
        == "cpu"


def test_ooc_lanczos_example_runs_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.examples.ooc_lanczos --device cpu` at a small
    size: SAFS and RAM spectra agree for both solvers, and a checkpointed
    run is suspended by a real SIGTERM (the hidden `--preempt-after`
    hook) and resumed to the RAM spectrum."""
    from repro_torch.examples import ooc_lanczos
    ooc_lanczos.main(["--n", "600", "--nnz", "5000", "--nev", "4",
                      "--device", "cpu", "--root", str(tmp_path / "p"),
                      "--trace", str(tmp_path / "t.jsonl")])
    out = capsys.readouterr().out
    assert "safs backend matches ram backend to rtol 1e-5" in out
    assert "physical disk I/O" in out and (tmp_path / "t.jsonl").exists()
    ooc_lanczos.main(["--n", "600", "--nnz", "5000", "--nev", "8",
                      "--solver", "lanczos", "--device", "cpu",
                      "--root", str(tmp_path / "l")])
    assert "safs backend matches ram backend to rtol 1e-5" in \
        capsys.readouterr().out
    ck = str(tmp_path / "ck")
    small = ["--n", "600", "--nnz", "5000", "--nev", "4", "--device", "cpu"]
    ooc_lanczos.main(small + ["--root", str(tmp_path / "c1"),
                              "--checkpoint", ck, "--preempt-after", "2"])
    assert "solve suspended at restart 2; resume with --resume" in \
        capsys.readouterr().out
    ooc_lanczos.main(small + ["--root", str(tmp_path / "c2"),
                              "--resume", ck])
    out = capsys.readouterr().out
    assert "safs backend matches ram backend to rtol 1e-5" in out
    assert "page snapshot:" in out
