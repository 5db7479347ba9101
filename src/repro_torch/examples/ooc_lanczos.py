"""End-to-end out-of-core eigensolve with the subspace and the matrix
image on disk (SAFS). Port of `examples/ooc_lanczos.py` for `--solver ks`.

    PYTHONPATH=src python -m repro_torch.examples.ooc_lanczos [--n 4000]
        [--nnz 48000] [--nev 8] [--root DIR] [--trace OUT.jsonl]
        [--device cpu]

An R-MAT graph, the semi-external SpMM operator and the Krylov–Schur
loop with the *entire vector subspace AND the matrix image living in
SAFS page files* (`TieredStore(backend="safs")`, §3.4.1, and
`GraphOperator(stream_image=True)`, §3.3.3): every host-tier byte goes
through the LRU page cache and the batched vectored I/O engine,
demotions retire through the async write-behind queue, and the readahead
pool keeps the next subspace group or image span in flight. On the card
(the default) the SpMM, gram and tsgemm kernels run on the blocks as
they arrive; `--device cpu` runs their plain versions.

The driver runs the identical solve on the ram backend and asserts that
the two spectra agree to rtol 1e-5, then prints logical against physical
tier traffic, prefetch overlap and the backend's `stats_dict()`. With
`--trace OUT.jsonl` the SAFS solve's spans are written there.

`--solver lanczos` and `--checkpoint/--resume` raise NotImplementedError:
block Lanczos is ROADMAP.md queue 1 item 3 and checkpoint/resume item 4.
"""
import argparse
import contextlib
import json
import os
import shutil
import tempfile

import numpy as np

from repro_torch.core import GraphOperator, TieredStore, solve
from repro_torch.graphs import normalized_adjacency, pack_tiles, rmat_graph
from repro_torch.obs import Tracer, tracing


def run_solve(image, nev, *, store, stream_image=False):
    # stream_image=True spills the edge tiles into the same page store as
    # the subspace: matmat then really is semi-external (§3.3.3)
    op = GraphOperator(image, store=store, stream_image=stream_image,
                       image_chunk_bytes=1 << 20)
    try:
        return solve(op, nev, method="krylov_schur", block_size=4,
                     store=store, group_size=2, tol=1e-7, max_iters=100)
    finally:
        op.delete_image()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--nnz", type=int, default=48000)
    ap.add_argument("--nev", type=int, default=8)
    ap.add_argument("--solver", choices=("ks", "lanczos"), default="ks")
    ap.add_argument("--root", default=None,
                    help="directory for the SAFS page files (default: tmp)")
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="record the SAFS solve's spans to this JSONL file")
    ap.add_argument("--checkpoint", default=None, metavar="DIR")
    ap.add_argument("--resume", default=None, metavar="DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.solver != "ks":
        raise NotImplementedError(
            "--solver lanczos: block Lanczos is not ported yet "
            "(ROADMAP.md queue 1 item 3)")
    if args.checkpoint or args.resume:
        raise NotImplementedError(
            "--checkpoint/--resume: checkpoint/resume is not ported yet "
            "(ROADMAP.md queue 1 item 4)")

    print(f"building RMAT graph: {args.n} vertices, ~{args.nnz} edges")
    r, c, v = rmat_graph(args.n, args.nnz, seed=1, symmetric=True)
    r, c, v = normalized_adjacency(args.n, r, c, v)
    image = pack_tiles(args.n, args.n, r, c, v, block_shape=(64, 64),
                       min_block_nnz=4)
    budget = 2 * image.shape[0] * 4 * 4      # two subspace blocks

    # in-memory reference: identical solve, ram backend
    ram_store = TieredStore(budget, device=args.device)
    ram = run_solve(image, args.nev, store=ram_store)

    root = args.root or tempfile.mkdtemp(prefix="ooc_lanczos_")
    own_tmp = args.root is None
    # cache: ~3 subspace blocks + 2 image spans — far below the total
    # footprint (subspace + image), so both genuinely stream
    safs_store = TieredStore(
        budget, backend="safs", device=args.device,
        backend_opts={"root": os.path.join(root, "pages"),
                      "cache_bytes": image.shape[0] * 4 * 4 * 3 + (2 << 20)})
    try:
        tracer = Tracer()
        with tracing(tracer) if args.trace else contextlib.nullcontext():
            disk = run_solve(image, args.nev, store=safs_store,
                             stream_image=True)
        if args.trace:
            tracer.write_jsonl(args.trace)
            print(f"trace: {args.trace}")

        w_ram = np.sort(ram.eigenvalues)
        w_disk = np.sort(disk.eigenvalues)
        print(f"eigenvalues (safs): {np.round(w_disk, 6)}")
        np.testing.assert_allclose(w_disk, w_ram, rtol=1e-5)
        print("safs backend matches ram backend to rtol 1e-5")

        safs_store.flush()
        s = safs_store.stats
        snap = safs_store.backend.stats_dict()
        d, pf, w = snap["io"], snap["prefetch"], snap["write_behind"]
        ratio = s.host_bytes_written / max(s.host_bytes_read, 1)
        print(f"logical tier I/O:  read {s.host_bytes_read / 1e6:8.1f} MB, "
              f"wrote {s.host_bytes_written / 1e6:6.1f} MB "
              f"(write/read = {ratio:.4f}; paper Table 3: 0.028)")
        print(f"streamed subspace passes: {s.passes} "
              f"({s.bytes_per_pass() / 1e6:.2f} MB/pass)")
        print(f"physical disk I/O: read {d['host_bytes_read'] / 1e6:8.1f} "
              f"MB, wrote {d['host_bytes_written'] / 1e6:6.1f} MB "
              f"(page-cache hits {d['cache_hits']}, misses "
              f"{d['cache_misses']})")
        print(f"readahead: {pf['bytes_prefetched'] / 1e6:.1f} MB staged by "
              f"{pf['io_workers']} workers (depth {pf['depth']}), "
              f"{pf['overlap_seconds'] * 1e3:.1f} ms of reads overlapped "
              f"compute")
        if w is not None:
            print(f"write-behind: {w['pages_retired']} pages retired in "
                  f"{w['batches_retired']} journaled batches (peak queue "
                  f"depth {w['max_depth_pages']} pages)")
        print(f"stats_dict: {json.dumps(snap)}")
        if not s.host_bytes_read > 10 * s.host_bytes_written:
            raise AssertionError("tier must be read-dominated "
                                 "(write-avoidance)")
    finally:
        safs_store.close()
        if own_tmp:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
