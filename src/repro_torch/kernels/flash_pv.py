"""Compare the bf16 flash kernel's two designs of the PV product on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_pv

The port's kernel feeds the softmax weights P to the PV product as a bf16
pair, P_hi = bf16(P) and P_lo = bf16(P - P_hi), in two wgmmas. The other
design, P_hi alone, is built from the same source with the macro
REPRO_FLASH_PV_HI_ONLY into a library of its own name; the port never
loads it. Both run on the same inputs:

  * error: DRAWS random draws of one head, 128 queries on 128 keys, d 64,
    not causal (an output of few large values, where the rounding of P
    shows most), each against the float32 plain version, as the largest
    |error| over the output's largest magnitude, beside the 2^-8 limit
    of the port's tests;
  * time: yi-9b's prefill shapes, q (4, 32, 2048, 128), k/v (4, 4, 2048,
    128), causal; ROUNDS rounds, each of which times both designs (the
    order alternates) as the median of REPS launches, every launch after
    a 256 MB write that evicts L2.

Prints the card's name and power limit, one line per measurement, and a
JSON line last. Needs one card of capability (9, 0) and `nvcc`.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build, flashattn
from repro_torch.kernels.flashattn_ref import attention_ref

HI_ONLY = "REPRO_FLASH_PV_HI_ONLY"
TOL = 2.0 ** -8          # of the output's largest magnitude
DRAWS, DRAW_SHAPE, DRAW_SEED = 128, (1, 1, 1, 128, 128, 64), 12
SERVE_SHAPE, SERVE_SEED = (4, 32, 4, 2048, 2048, 128), 11
ROUNDS, REPS = 8, 10


def _qkv(gen, b, h, hkv, sq, sk, d):
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


def _rel_err(got, q, k, v, causal) -> float:
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    return float((got.float() - want).abs().max() / want.abs().max())


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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_pv: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    hi_only = _build.load(_build.build(defines=(HI_ONLY,)))
    designs = {"P_hi + P_lo (shipped)": _build.lib,
               "P_hi alone": lambda: hi_only}

    def run(library, q, k, v, causal):
        return flashattn.launch_with(library, q, k, v, causal=causal)[0]

    gen = torch.Generator(device="cuda").manual_seed(DRAW_SEED)
    errs = {name: [] for name in designs}
    for _ in range(DRAWS):
        q, k, v = _qkv(gen, *DRAW_SHAPE)
        for name, library in designs.items():
            errs[name].append(_rel_err(run(library, q, k, v, False),
                                       q, k, v, False))
    for name, e in errs.items():
        print(f"{name}: {DRAWS} draws of {DRAW_SHAPE} not causal: largest "
              f"rel err {max(e):.4e}, median {statistics.median(e):.4e}, "
              f"{sum(x > TOL for x in e)} above {TOL:g}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    b, h, hkv, sq, sk, d = SERVE_SHAPE
    q, k, v = _qkv(gen, *SERVE_SHAPE)
    serve_err = {name: _rel_err(run(library, q, k, v, True), q, k, v, True)
                 for name, library in designs.items()}
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rounds = {name: [] for name in designs}
    names = list(designs)
    for r in range(ROUNDS):
        for name in names if r % 2 == 0 else names[::-1]:
            library = designs[name]
            rounds[name].append(_ms(lambda: run(library, q, k, v, True),
                                    flush))
    flops = 4 * d * b * h * sq * (sq + 1) // 2
    result = {"card": card, "draws": DRAWS, "tol": TOL, "designs": {}}
    for name in designs:
        ms = statistics.median(rounds[name])
        print(f"{name}: serve shapes {SERVE_SHAPE} causal: rel err "
              f"{serve_err[name]:.4e}; ms per round "
              f"{[round(t, 4) for t in rounds[name]]}, median {ms:.4f} = "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        result["designs"][name] = {
            "draws_max_rel_err": max(errs[name]),
            "draws_above_tol": sum(x > TOL for x in errs[name]),
            "serve_rel_err": serve_err[name], "serve_ms_rounds":
            rounds[name], "serve_ms": ms}
    ratios = [a / b for a, b in zip(*rounds.values())]
    print(f"shipped / P_hi alone per round: "
          f"{[round(x, 4) for x in ratios]}, median "
          f"{statistics.median(ratios):.4f}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
