"""Time another source tree's float32 flash forward beside the port's on
the card, and name the SDPA kernels that serve as the float32 yardstick.

    PYTHONPATH=src python -m repro_torch.kernels.flash_compare DIR

DIR holds another version of `csrc/flashattn.cu` and the headers it
includes, e.g. an earlier commit's (`git show
<rev>:src/repro_torch/kernels/csrc/flashattn.cu` and `.../hopper.cuh`),
whose `repro_flash_attention_f32` has the port's C interface. It is built
with the port's nvcc flags into a library of its own, which the port
never loads. At the float32 shape of chip_smoke.py's phase 32b (q (1, 12,
1024, 128), k/v (1, 2, 1024, 128), causal, strided (B, S, H, d) views),
TF32 off:

  * error: each kernel's output against the float32 plain version, as
    the largest |error| over the output's largest magnitude;
  * time: ROUNDS rounds, each of which times both kernels (the order
    alternates) and SDPA's float32 forward, each the median of REPS
    launches after a 256 MB write that evicts L2;
  * the device kernels of one SDPA forward and of one SDPA backward, by
    name and ms (the backend that ran).

Prints the card's name and power limit, one line per measurement, and a
JSON line last. Needs one card of capability (9, 0) and `nvcc`.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, flashattn
from repro_torch.kernels.flashattn_ref import attention_ref

SHAPE, SEED = (1, 12, 2, 1024, 128), 32   # (B, H, Hkv, S, d), causal
ROUNDS, REPS = 4, 10


def _build_other(csrc: Path, out_dir: Path) -> ctypes.CDLL:
    """DIR/flashattn.cu as a shared library of its own name."""
    lib = out_dir / "libflash_other.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{csrc}",
                    "-shared", "-o", str(lib), str(csrc / "flashattn.cu")],
                   check=True, capture_output=True, text=True)
    handle = ctypes.CDLL(str(lib))
    fn = handle.repro_flash_attention_f32
    fn.argtypes = _build.SIGNATURES["repro_flash_attention_f32"]
    fn.restype = ctypes.c_int
    return handle


def _ms(fn, flush) -> float:
    fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_kernels(fn) -> dict[str, float]:
    """Device ms of one call of fn by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:100]: round(e.self_device_time_total / 1e3, 4)
            for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))}


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not (Path(argv[0]) / "flashattn.cu").is_file():
        print("usage: python -m repro_torch.kernels.flash_compare DIR "
              "(DIR/flashattn.cu and its headers)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_compare: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card} | TF32 for matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        other = _build_other(Path(argv[0]).resolve(), Path(tmp))
        kernels = {"other": lambda: other, "port": _build.lib}
        b, h, hkv, s, d = SHAPE
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda")
                   .transpose(1, 2) for n in (h, hkv, hkv))
        want = attention_ref(q, k, v, causal=True)

        def run(name):
            return flashattn.launch_with(kernels[name], q, k, v,
                                         causal=True)[0]

        sdpa = (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        errs = {name: float((fn() - want).abs().max() / want.abs().max())
                for name, fn in (("other", lambda: run("other")),
                                 ("port", lambda: run("port")),
                                 ("sdpa", sdpa))}
        flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        rounds = {name: [] for name in (*kernels, "sdpa")}
        for r in range(ROUNDS):
            order = ["other", "port"] if r % 2 == 0 else ["port", "other"]
            for name in order:
                rounds[name].append(_ms(lambda: run(name), flush))
            rounds["sdpa"].append(_ms(sdpa, flush))
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                             enable_gqa=True)
        do = torch.randn(out.shape, generator=gen, device="cuda")
        backend = {
            "forward": _device_kernels(sdpa),
            "backward": _device_kernels(lambda: torch.autograd.grad(
                out, (qs, ks, vs), do, retain_graph=True))}
    result = {"card": card, "shape": SHAPE, "causal": True, "rel_err": errs,
              "ms_rounds": {n: [round(t, 4) for t in ts]
                            for n, ts in rounds.items()},
              "ms_median": {n: statistics.median(ts)
                            for n, ts in rounds.items()},
              "sdpa_kernels": backend}
    for name, ts in rounds.items():
        print(f"{name}: float32 forward q {(b, h, s, d)} k/v {(b, hkv, s, d)}"
              f" causal | rel err {errs[name]:.3e} | ms per "
              f"round {result['ms_rounds'][name]}, median "
              f"{result['ms_median'][name]:.4f}", flush=True)
    for kind, by_name in backend.items():
        print(f"sdpa {kind} device kernels (ms): {json.dumps(by_name)}",
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
