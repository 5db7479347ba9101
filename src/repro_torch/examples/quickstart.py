"""Quickstart: compute 8 eigenvalues of a power-law graph out-of-core.
Port of `examples/quickstart.py`.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds an RMAT graph, packs the block-sparse matrix image, runs the
tiered (out-of-core) Block Krylov-Schur eigensolver, and checks the
spectrum against scipy. Prints the byte-exact tier I/O accounting —
the paper's Table-3 read/write shape at laptop scale. Runs on the CUDA
card (the SpMM, gram and tsgemm kernels) unless `--device cpu`.
"""
import argparse
import json

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from repro_torch.core import GraphOperator, TieredStore, eigsh, true_residuals
from repro_torch.graphs import normalized_adjacency, pack_tiles, rmat_graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    n, nnz, nev = 5000, 60000, 8
    print(f"building RMAT graph: {n} vertices, ~{nnz} edges")
    r, c, v = rmat_graph(n, nnz, seed=1, symmetric=True)
    r, c, v = normalized_adjacency(n, r, c, v)
    image = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
    print(f"matrix image: {image.nblocks} dense blocks + "
          f"{image.coo_vals.size} COO entries, "
          f"{image.nbytes_image() / 1e6:.1f} MB")

    # device tier budgeted below the subspace size → genuinely out-of-core
    store = TieredStore(device_budget_bytes=2 * n * 4 * 4, device=args.device)
    op = GraphOperator(image, store=store)
    res = eigsh(op, nev, block_size=4, tol=1e-6, max_restarts=100,
                which="LM", store=store)
    print(f"eigenvalues: {np.round(np.sort(res.eigenvalues), 5)}")
    print(f"converged={res.converged} restarts={res.n_restarts} "
          f"SpMM-calls={res.n_ops}")

    a = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    w = np.sort(spla.eigsh(a, k=nev, which="LM", return_eigenvectors=False))
    err = np.abs(np.sort(res.eigenvalues) - w).max()
    print(f"max |err| vs scipy: {err:.2e}")
    tr = true_residuals(op, res.eigenvectors, res.eigenvalues)
    print(f"max true residual:  {tr.max():.2e}")

    s = store.stats
    print(f"tier I/O: read {s.host_bytes_read / 1e6:.1f} MB, "
          f"wrote {s.host_bytes_written / 1e6:.1f} MB "
          f"(write/read = {s.host_bytes_written / max(s.host_bytes_read, 1):.4f};"
          f" paper Table 3: 0.028)")
    print(f"IOStats: {json.dumps(res.io_stats)}")
    if not (res.converged and err < 1e-4):
        raise AssertionError(f"quickstart solve: converged={res.converged}, "
                             f"max |err| vs scipy {err:.2e} (limit 1e-4)")
    return res


if __name__ == "__main__":
    main()
