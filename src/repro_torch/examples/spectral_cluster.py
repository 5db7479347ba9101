"""Spectral clustering on a planted-partition graph — the paper's target
application [17, 22]. Port of `examples/spectral_cluster.py`.

    PYTHONPATH=src python -m repro_torch.examples.spectral_cluster
    PYTHONPATH=src python -m repro_torch.examples.spectral_cluster \
        --method lobpcg
    PYTHONPATH=src python -m repro_torch.examples.spectral_cluster \
        --laplacian [--device cpu]

Embeds vertices with the top-k eigenvectors of the normalized adjacency
(equivalently, with `--laplacian`, the smallest-eigenvalue eigenvectors of
the normalized Laplacian L = I − Â) and recovers the planted communities
with spherical k-means. Any registered member of the solver family
(`repro_torch.core.solve`) computes the embedding — the two spectral
views and all methods must land on the same partition. Runs on the CUDA
card (the SpMM, gram and tsgemm kernels) unless `--device cpu`.
"""
import argparse

import numpy as np

from repro_torch.core import GraphOperator, TieredStore, solve
from repro_torch.graphs import normalized_adjacency, pack_tiles


class LaplacianOperator:
    """Normalized Laplacian L = I − Â as a streamed operator: one Â tile
    pass per apply, identity added on the fly. Its smallest eigenpairs are
    Â's largest, so the two CLI modes must agree."""

    def __init__(self, adj_op):
        self.adj = adj_op
        self.n = adj_op.n
        self.device = adj_op.device

    def matmat(self, x):
        return x - self.adj.matmat(x)


def planted_partition(n=3000, k=4, d_avg=12, p_in=0.85, seed=0):
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(k), n // k)
    rows, cols = [], []
    for i in range(n):
        for _ in range(d_avg):
            j = int(rng.integers(0, n))
            p = p_in if labels[i] == labels[j] else (1 - p_in) / (k - 1)
            if rng.random() < p and i != j:
                rows.append(i)
                cols.append(j)
    r = np.array(rows + cols, np.int32)
    c = np.array(cols + rows, np.int32)
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    return labels, r[idx], c[idx], np.ones(idx.size, np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="krylov_schur",
                    choices=("krylov_schur", "lobpcg"),
                    help="solver-family member computing the embedding")
    ap.add_argument("--laplacian", action="store_true",
                    help="embed with the SMALLEST eigenpairs of L = I − Â "
                         "instead of the largest of Â")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    n, k = 3000, 4
    labels, r, c, v = planted_partition(n, k)
    print(f"planted partition: {n} vertices, {r.size} edges, {k} blocks")
    r2, c2, v2 = normalized_adjacency(n, r, c, v)
    image = pack_tiles(n, n, r2, c2, v2, block_shape=(64, 64),
                       min_block_nnz=4)
    store = TieredStore(device=args.device)
    adj = GraphOperator(image, store=store)
    if args.laplacian:
        op, which = LaplacianOperator(adj), "SA"
    else:
        op, which = adj, "LA"
    res = solve(op, k, method=args.method, which=which, tol=1e-6,
                max_iters=200, block_size=k if args.method == "krylov_schur"
                else 2 * k, store=store)
    emb = res.eigenvectors[:n].cpu().numpy()
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)

    cents = emb[np.linspace(0, n - 1, k).astype(int)]
    for _ in range(30):
        assign = np.argmax(emb @ cents.T, axis=1)
        cents = np.stack([emb[assign == i].mean(0) if (assign == i).any()
                          else cents[i] for i in range(k)])
        cents /= np.linalg.norm(cents, axis=1, keepdims=True) + 1e-12
    purity = sum(np.bincount(labels[assign == i]).max()
                 for i in range(k) if (assign == i).any()) / n
    spec = "L = I - A_hat (smallest)" if args.laplacian \
        else "A_hat (largest)"
    print(f"method={args.method}  spectrum={spec}")
    print(f"eigenvalues: {np.round(np.sort(res.eigenvalues), 4)}")
    print(f"cluster purity: {purity:.3f}")
    assert purity > 0.9
    return purity


if __name__ == "__main__":
    main()
