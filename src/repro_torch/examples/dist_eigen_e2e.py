"""End-to-end sharded eigensolve: the core restart loop driving the dist
layer. Port of `examples/dist_eigen_e2e.py`.

    PYTHONPATH=src python -m repro_torch.examples.dist_eigen_e2e [--n 4000]
        [--nnz 48000] [--nev 8] [--block-size 4] [--ranks 8]
        [--backend gloo|nccl] [--root DIR] [--pod-compressed]
        [--device cpu]

The integration the paper's headline result is about (§3 + §4 in one
pipeline): `core.eigsh` owns the Krylov–Schur restarts and the
out-of-core subspace, while every expansion runs as one fused SpMM +
CGS2 + CholQR2 step (`dist.build_eigen_step`) over edge panels spread
over the ranks of a (pod, data, model) mesh (`dist.e2e_mesh`'s layout).
The ranks are processes (`dist.spawn`); rank 0 is the controller.
Residencies follow the paper's split:

  * edge panels: packed once, one per rank, as the solver's block image
    on the rank's device (the SSD-streamed operand);
  * subspace history: each rank's row shard of the (nb_v, n_pad, b)
    stack, consumed in place by the fused step ("recent matrix cached in
    fast memory");
  * the MultiVector system of record on the controller spills to SAFS
    page files (`TieredStore(backend="safs")`): restart compression and
    eigenvector materialization stream it back ("subspace on SSD").

Every rank runs `run_ranks`: rank 0 factors the same R-MAT graph through
the local `GraphOperator` path too, and both solves start from one
natural-space block. The driver asserts spectrum parity to rtol 1e-5,
then (optionally) runs the int8 cross-pod reduction variant
(`pod_compressed=True`) and reports its per-restart eigenvalue deviation.
On the card (the default) the ranks run the SpMM, gram and tsgemm
kernels; `--device cpu` runs their plain versions, with gloo.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np


def make_graph(spec):
    """(n, rows, cols, vals) of a graph spec (kind, n, nnz, seed):
    "rmat_spectral" (the reference's e2e graph) or "rmat_normalized"
    (`rmat_graph(..., symmetric=True)` normalized, chip_smoke.py's)."""
    from repro_torch.graphs import (normalized_adjacency, rmat_graph,
                                    rmat_spectral)
    kind, n, nnz, seed = spec
    if kind == "rmat_spectral":
        return (n, *rmat_spectral(n, nnz, seed=seed))
    if kind == "rmat_normalized":
        return (n, *normalized_adjacency(
            n, *rmat_graph(n, nnz, seed=seed, symmetric=True)))
    raise ValueError(f"unknown graph kind {kind!r}")


def start_block(n: int, b: int, seed: int) -> np.ndarray:
    """The natural-space (n, b) start block both paths map into their
    own layout."""
    return np.random.default_rng(seed).standard_normal((n, b)).astype(
        np.float32)


def _timed_solve(op, cfg: dict, x0, store=None) -> dict:
    """Rank 0: the solve and its true residuals (a matmat the workers take
    part in when op is a DistOperator)."""
    import torch
    from repro_torch.core import eigsh, true_residuals
    from repro_torch.device import synchronize
    synchronize(op.device)
    t0 = time.perf_counter()
    res = eigsh(op, cfg["nev"], block_size=cfg["block_size"],
                num_blocks=cfg.get("num_blocks"), tol=cfg["tol"],
                max_restarts=cfg["max_restarts"], store=store, x0=x0)
    synchronize(op.device)
    wall = time.perf_counter() - t0
    resid = true_residuals(op, res.eigenvectors, res.eigenvalues)
    finite = bool(torch.isfinite(res.eigenvectors).all())
    return {"eigenvalues": [float(x) for x in res.eigenvalues],
            "converged": bool(res.converged),
            "restarts": int(res.n_restarts), "n_ops": int(res.n_ops),
            "io_stats": res.io_stats, "wall_s": wall,
            "true_residuals": [float(x) for x in resid],
            "vectors_shape": list(res.eigenvectors.shape),
            "vectors_finite": finite}


def _launches() -> dict:
    """The kernel wrappers' launch counts in this process."""
    from repro_torch.kernels import gram, spmm_tile, tsgemm
    return {"spmm_blocksparse": spmm_tile.LAUNCHES, "gram": gram.LAUNCHES,
            "tsgemm": tsgemm.LAUNCHES}


def _rel_err(got, want, scale) -> float:
    """max |got − want| / Σ|terms| elementwise (0 where both are 0)."""
    diff = (got.double() - want.double()).abs()
    ok = scale > 0
    if bool((diff[~ok] > 0).any()):
        return float("inf")
    return float((diff[ok] / scale[ok]).max()) if bool(ok.any()) else 0.0


def kernel_check(dop, tol: float) -> dict:
    """This rank's kernels at the shapes its fused solve gave them, against
    exact float64 products: every rank calls it after the solve (the
    operand's all-gather is a collective), after its launch counts were
    read, so these launches do not count.

    The SpMM (the panel's image, and a copy of it with impl="ref") on the
    solve's last operand, the subspace stack's last block all-gathered
    over the row axes and zero-padded as `Panel.contract` pads it, each
    within `spmm_ref.float32_sum_bound` (max(tol, γ_{m+1}) of Σ|terms|,
    m a row's nonzero terms). gram and tsgemm and their plain versions
    as CGS2 runs them at (s, b): Vⱼᵀ·q and q − Vⱼ·hⱼ for every block Vⱼ
    of the stack and q its last, each within tol of Σ|terms|. Returns
    the kernels' and plain versions' errors relative to Σ|terms|, the
    SpMM's largest share of its bound, and the failures."""
    import copy

    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmm_ref import float32_sum_bound, spmm_f64
    vs = dop._vstack.float()
    q = vs[-1].contiguous()
    x = dop.panel.pad(dop.mesh.all_gather(q, "rows"))
    image = dop.panel.image
    plain = copy.copy(image)
    plain.impl = "ref"
    exact, terms, count = spmm_f64(image._blocks, image._block_cols,
                                   image._row_ptr, image._coo, x)
    bound = float32_sum_bound(terms, count, tol)
    b = x.shape[1]
    errs, plain_errs, of_bound, failures = {}, {}, {}, []
    for name, y, out in (("kernel", image.matmat(x), errs),
                         ("plain", plain.matmat(x), plain_errs)):
        over = ((y.double() - exact).abs() / bound).nan_to_num(
            nan=0.0, posinf=float("inf"))          # 0 / 0 in empty rows
        out[f"spmm k{b}"] = _rel_err(y, exact, terms)
        of_bound[name] = float(over.max())
        if bool((over > 1).any()):
            failures.append(f"spmm k{b}: the {name} version off the "
                            f"float64 product by {float(over.max()):.3g} "
                            f"times its float32 bound")
    del exact, terms, count, bound
    s = tuple(q.shape)
    for impl, out in (("auto", errs), ("ref", plain_errs)):
        g_err = t_err = 0.0
        for vj in vs:
            vj = vj.contiguous()
            g_exact = vj.double().T @ q.double()
            g_terms = vj.abs().double().T @ q.abs().double()
            g_err = max(g_err, _rel_err(ops.gram(vj, q, impl=impl), g_exact,
                                        g_terms))
            hj = ops.gram(vj, q, impl="ref")
            t_exact = q.double() - vj.double() @ hj.double()
            t_terms = (vj.abs().double() @ hj.abs().double()
                       + q.abs().double())
            t_err = max(t_err, _rel_err(
                ops.tsgemm(vj, hj, alpha=-1.0, beta=1.0, c0=q, impl=impl),
                t_exact, t_terms))
        out[f"gram {s[0]}x{s[1]}"], out[f"tsgemm {s[0]}x{s[1]}"] = (g_err,
                                                                     t_err)
    bad = {k: e for k, e in errs.items()
           if not k.startswith("spmm") and not e <= tol}
    if bad:
        failures.append(f"kernels off the float64 product (tol {tol:g} of "
                        f"Σ|terms|): {bad}")
    return {"errs": errs, "plain_errs": plain_errs, "of_bound": of_bound,
            "failures": failures}


def _safs_store(n_pad: int, b: int, root: str, device):
    from repro_torch.core import TieredStore
    return TieredStore(device_budget_bytes=2 * n_pad * 4 * b, backend="safs",
                       backend_opts={"root": os.path.join(root, "pages"),
                                     "cache_bytes": 3 * n_pad * 4 * b},
                       device=device)


def run_ranks(mesh, cfg: dict) -> dict:
    """Every rank of the world runs this (a `dist.spawn` target; a
    (1, 1, 1) mesh runs it in the caller's process). cfg:

      graph            (kind, n, nnz, seed), built on every rank
      nev, block_size, num_blocks, tol, max_restarts   the solve
      x0_seed          seed of the natural-space start block
      local            rank 0 also solves over a GraphOperator
      safs_root        rank 0 keeps the subspace in SAFS page files there
      pod_restarts     restarts of the pod-compressed run (0: none)
      w_reference      its reference spectrum (default: local, else dist)
      compressed       also solve over the 6-byte/edge stream (tol 1e-4,
                       at most 20 restarts, the reference's test)
      kernel_check     a tolerance: check this rank's kernels at its
                       shapes after the dist solve (`kernel_check`)

    The pod-compressed and compressed runs share the dist operator's
    panel (`DistOperator.variant`): the graph is packed once a rank.

    Returns this rank's figures: its panel (entries, dense blocks, COO
    share), and of the dist solve its kernel launches, collective bytes
    beside the analytic count, host-staged bytes and peak device memory;
    rank 0 adds the results.
    """
    import torch
    from repro_torch.core import GraphOperator
    from repro_torch.device import synchronize
    from repro_torch.dist import DistOperator, pod_compressed_deviation
    from repro_torch.graphs import pack_tiles

    n, r, c, v = make_graph(cfg["graph"])
    b, nev, dev = cfg["block_size"], cfg["nev"], mesh.device
    x_nat = start_block(n, b, cfg.get("x0_seed", 0))
    out: dict = {"rank": mesh.rank, "mesh": mesh.describe()}
    if mesh.rank == 0 and cfg.get("local"):
        tm = pack_tiles(n, n, r, c, v, block_shape=(64, 64), min_block_nnz=4)
        x_loc = np.zeros((tm.shape[0], b), np.float32)  # the image pads n
        x_loc[:n] = x_nat
        out["local"] = _timed_solve(GraphOperator(tm, device=dev), cfg,
                                    x_loc)
        del tm

    t0 = time.perf_counter()
    dop = DistOperator(n, r, c, v, mesh=mesh)
    synchronize(dev)
    out["build_s"] = time.perf_counter() - t0
    x0 = dop.nat_to_pad(x_nat)
    p = dop.panel
    out["panel"] = {"n_pad": dop.n, "e_loc": dop.e_loc,
                    "entries": p.n_entries, "blocks": p.n_blocks,
                    "coo": p.n_coo, "coo_share": p.coo_share,
                    "image_bytes": p.image_bytes}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh.reset_counters()
    before = _launches()
    root = cfg.get("safs_root")
    store = (_safs_store(dop.n, b, root, dev)
             if root is not None and mesh.rank == 0 else None)
    try:
        res = dop.drive(_timed_solve, dop, cfg, x0, store)
    finally:
        if store is not None:
            out["safs"] = {"logical": store.stats.as_dict(),
                           "physical": store.backend.stats.as_dict()}
            store.close()
    out["launches"] = {k: v - before[k] for k, v in _launches().items()}
    out["bytes"] = dict(mesh.bytes)
    out["analytic_bytes"] = dict(dop.analytic_bytes)
    out["fused_steps"] = dop.n_fused_steps
    if dev.type == "cuda":
        out["peak_device_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    last_h, last_r = dop.last_hr
    out["last_h"], out["last_r"] = last_h.cpu().numpy(), last_r.cpu().numpy()
    if res is not None:
        out["dist"] = res
    if cfg.get("kernel_check"):
        out["kernel_check"] = kernel_check(dop, cfg["kernel_check"])

    if cfg.get("pod_restarts"):
        w_ref = cfg.get("w_reference")
        if w_ref is None and mesh.rank == 0:
            w_ref = (out["local"] if "local" in out else res)["eigenvalues"]
        devs = pod_compressed_deviation(
            n, r, c, v, np.zeros(nev) if w_ref is None else w_ref,
            mesh=mesh, nev=nev, block_size=b,
            max_restarts=cfg["pod_restarts"], x0=x0, base=dop)
        if devs is not None:
            out["pod_compressed"] = devs
    if cfg.get("compressed"):
        dz = dop.variant(compressed=True)
        zcfg = dict(cfg, tol=1e-4, max_restarts=20)
        rz = dz.drive(_timed_solve, dz, zcfg, x0)
        out["stream_bytes"] = dz.cpanel.stream_bytes
        if rz is not None:
            out["compressed"] = rz
    synchronize(dev)
    return out


def world(cfg: dict, *, ranks: int, backend: str, device=None,
          timeout: float = 900.0) -> list:
    """run_ranks on every rank of a new world of `ranks` processes laid
    out as `dist.e2e_mesh` lays them; one rank runs in this process on a
    (1, 1, 1) mesh with no world."""
    from repro_torch.dist import Mesh, spawn
    from repro_torch.dist.dist_operator import e2e_shape
    if ranks == 1:
        return [run_ranks(Mesh((1, 1, 1), device=device), cfg)]
    return spawn(run_ranks, e2e_shape(ranks), backend=backend,
                 device=device, args=(cfg,), timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--nnz", type=int, default=48000)
    ap.add_argument("--nev", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=8,
                    help="processes of the (pod, data, model) mesh")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="nccl needs a card per rank; gloo shares one")
    ap.add_argument("--root", default=None,
                    help="directory for the SAFS page files (default: tmp)")
    ap.add_argument("--pod-compressed", action="store_true",
                    help="also run the int8 cross-pod reduction variant")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    device = str(resolve_device(args.device))

    root = args.root or tempfile.mkdtemp(prefix="dist_e2e_")
    cfg = dict(graph=("rmat_spectral", args.n, args.nnz, 1), nev=args.nev,
               block_size=args.block_size, tol=1e-7, max_restarts=100,
               x0_seed=0, local=True, safs_root=root,
               pod_restarts=8 if args.pod_compressed else 0)
    print(f"building RMAT graph: {args.n} vertices, ~{args.nnz} edges; "
          f"{args.ranks} rank(s) over {args.backend} on {device}")
    try:
        outs = world(cfg, ranks=args.ranks, backend=args.backend,
                     device=device)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    head = outs[0]
    w_dist = np.sort(head["dist"]["eigenvalues"])
    w_local = np.sort(head["local"]["eigenvalues"])
    print(f"{head['mesh']}, n_pad={head['panel']['n_pad']}, "
          f"e_loc={head['panel']['e_loc']}")
    print(f"eigenvalues (dist):  {np.round(w_dist, 6)}")
    print(f"eigenvalues (local): {np.round(w_local, 6)}")
    np.testing.assert_allclose(w_dist, w_local, rtol=1e-5)
    print(f"sharded path matches local path to rtol 1e-5 "
          f"({head['fused_steps']} fused expansions, local "
          f"{head['local']['wall_s']:.2f}s vs dist "
          f"{head['dist']['wall_s']:.2f}s)")
    s, d = head["safs"]["logical"], head["safs"]["physical"]
    print(f"subspace spill (SAFS) on rank 0: logical wrote "
          f"{s['host_bytes_written'] / 1e6:.1f} MB / read "
          f"{s['host_bytes_read'] / 1e6:.1f} MB; physical disk wrote "
          f"{d['host_bytes_written'] / 1e6:.1f} MB / read "
          f"{d['host_bytes_read'] / 1e6:.1f} MB (page hits "
          f"{d['cache_hits']}, misses {d['cache_misses']})")
    for o in outs:
        print(f"rank {o['rank']}: collective bytes {o['bytes']} "
              f"(analytic {o['analytic_bytes']}), panel COO share "
              f"{o['panel']['coo_share']:.3f}")
    print("fused path note: expansions stream zero subspace bytes from the "
          "store — only restart compression and the final Ritz GEMM do")
    if args.pod_compressed:
        devs = head["pod_compressed"]
        print(f"pod_compressed deviation per restart: "
              f"{[f'{x:.2e}' for x in devs]}")
    return outs


if __name__ == "__main__":
    main()
