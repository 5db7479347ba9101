"""Time another source tree's block-sparse SpMM kernel beside the port's
on the card, over the rmat-1M image.

    PYTHONPATH=src python -m repro_torch.kernels.spmm_compare DIR

DIR holds another version of `csrc/spmm_tile.cu` and any header it
includes, e.g. an earlier commit's (`git show
<rev>:src/repro_torch/kernels/csrc/spmm_tile.cu`), whose
`repro_spmm_blocksparse_f32` and `_bf16` have the port's C interface. It
is built with the port's nvcc flags into a library of its own name,
which the port never loads. The image is chip_smoke.py's: `rmat_graph(2**20,
2**23, seed=1)`, normalized, packed into 64×64 blocks of at least 4
entries (12.86 GB of float32 blocks, 6.43 GB cast to bf16 on the card),
with the work plan the operator builds. At float32 k = 1, 2, 4, 8 and
bf16 blocks at k = 4:

  * error: each kernel's output against the plain version, as the
    largest |error| over Σ|terms| of the element (the image has no
    negative entry, so Σ|terms| is the plain product with |X|), held to
    TOL; and bit identity over two calls;
  * time: ROUNDS rounds, each of which times both kernels in alternating
    order, each the median of REPS launches after a 256 MB write that
    evicts L2;
  * the bound: the bytes the call must move (blocks, block columns,
    row_ptr, X, Y) over 3.35 TB/s.

Prints the card's name and power limit, one line per row, and a JSON line
last. Needs one card of capability (9, 0), `nvcc` and ~35 GB of device
memory.
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

from repro_torch.kernels import _build, spmm_tile
from repro_torch.kernels.spmm_ref import spmm_ref

N_LOG2, NNZ_LOG2, GRAPH_SEED, MIN_BLOCK_NNZ = 20, 23, 1, 4
ROWS = ((torch.float32, 1), (torch.float32, 2), (torch.float32, 4),
        (torch.float32, 8), (torch.bfloat16, 4))
ROUNDS, REPS, SEED = 4, 10, 28
TOL = 1e-5                   # of Σ|terms|, per element (chip_smoke.py's)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)


def _build_other(csrc: Path, out_dir: Path) -> ctypes.CDLL:
    """DIR/spmm_tile.cu as a shared library of its own name."""
    lib = out_dir / "libspmm_other.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{csrc}",
                    "-shared", "-o", str(lib), str(csrc / "spmm_tile.cu")],
                   check=True, capture_output=True, text=True)
    handle = ctypes.CDLL(str(lib))
    for name in ("repro_spmm_blocksparse_f32", "repro_spmm_blocksparse_bf16"):
        fn = getattr(handle, name)
        fn.argtypes = _build.SIGNATURES[name]
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


def _image(dev):
    """The rmat-1M image on the card: blocks, block columns, row_ptr."""
    from repro_torch.graphs import normalized_adjacency, pack_tiles
    from repro_torch.graphs import rmat_graph
    n = 2 ** N_LOG2
    r, c, v = rmat_graph(n, 2 ** NNZ_LOG2, seed=GRAPH_SEED, symmetric=True)
    r, c, v = normalized_adjacency(n, r, c, v)
    tm = pack_tiles(n, n, r, c, v, block_shape=(64, 64),
                    min_block_nnz=MIN_BLOCK_NNZ)
    return (torch.from_numpy(tm.blocks).to(dev),
            torch.from_numpy(tm.block_cols).to(dev),
            torch.from_numpy(tm.row_ptr).to(dev))


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not (Path(argv[0]) / "spmm_tile.cu").is_file():
        print("usage: python -m repro_torch.kernels.spmm_compare DIR "
              "(DIR/spmm_tile.cu and its headers)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("spmm_compare: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        other = _build_other(Path(argv[0]).resolve(), Path(tmp))
        kernels = {"other": lambda: other, "port": _build.lib}
        blocks32, cols, ptr = _image(dev)
        plan = spmm_tile.plan(ptr)
        counts = (ptr[1:] - ptr[:-1]).long()
        block_rows = torch.repeat_interleave(
            torch.arange(ptr.shape[0] - 1, device=dev), counts)
        n_rows = ptr.shape[0] - 1
        images = {torch.float32: blocks32,
                  torch.bfloat16: blocks32.to(torch.bfloat16)}
        print(f"image: blocks {tuple(blocks32.shape)}, plan of "
              f"{plan.items.shape[0]} items, {plan.splits.shape[0]} split "
              f"rows", flush=True)
        flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        results = []
        for dtype, k in ROWS:
            blocks = images[dtype]
            x = torch.randn((blocks32.shape[2] * (ptr.shape[0] - 1), k),
                            generator=gen, device=dev)

            def run(name, blocks=blocks, x=x):
                return spmm_tile.launch_with(kernels[name], blocks, cols,
                                             ptr, x, plan=plan)

            want = spmm_ref(blocks, cols, block_rows, n_rows, x)
            scale = spmm_ref(blocks, cols, block_rows, n_rows, x.abs())
            errs, same = {}, {}
            for name in kernels:
                got = run(name)
                same[name] = bool(torch.equal(got, run(name)))
                errs[name] = float(((got - want).abs() / scale.clamp_min(
                    1e-30)).max())
                del got
            del want, scale
            rounds = {name: [] for name in kernels}
            for r in range(ROUNDS):
                order = ["other", "port"] if r % 2 == 0 else ["port", "other"]
                for name in order:
                    rounds[name].append(_ms(lambda: run(name), flush))
            nbytes = (blocks.numel() * blocks.element_size()
                      + cols.numel() * 4 + ptr.numel() * 4
                      + x.numel() * 4 + n_rows * 64 * k * 4)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            med = {n: statistics.median(ts) for n, ts in rounds.items()}
            row = {"dtype": str(dtype).removeprefix("torch."), "k": k,
                   "rel_err": errs, "bit_identical": same,
                   "ms_rounds": {n: [round(t, 4) for t in ts]
                                 for n, ts in rounds.items()},
                   "ms_median": med, "bound_ms": bound,
                   "share_of_bound": {n: bound / t for n, t in med.items()},
                   "port_over_other": med["port"] / med["other"]}
            results.append(row)
            print(f"{row['dtype']} k={k}: other {med['other']:.4f} ms, port "
                  f"{med['port']:.4f} ms (x{row['port_over_other']:.3f}) | "
                  f"bound {bound:.4f} ms (bytes): share other "
                  f"{bound / med['other']:.3f}, port {bound / med['port']:.3f}"
                  f" | rel err other {errs['other']:.3e}, port "
                  f"{errs['port']:.3e} (tol {TOL:g} of Σ|terms|) | "
                  f"bit-identical {same} | rounds {row['ms_rounds']}",
                  flush=True)
    bad = [r for r in results
           if not all(e <= TOL for e in r["rel_err"].values())
           or not all(r["bit_identical"].values())]
    print(json.dumps({"card": card, "rows": results}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
