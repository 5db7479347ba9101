"""The eigensolver pointed at an LM's loss curvature: the top eigenvalues
of the Hessian of a (reduced) architecture's loss, through matrix-free
Hessian-vector products. Port of `examples/curvature_spectrum.py`.

    PYTHONPATH=src python -m repro_torch.examples.curvature_spectrum
    PYTHONPATH=src python -m repro_torch.examples.curvature_spectrum \
        --arch mamba2-780m --device cpu

The same Block Krylov-Schur solve that eigendecomposes graphs runs over
`HvpOperator`: one Hessian-vector product per column of a block. The
defaults are the reference's: reduced qwen2-1.5b drawn from seed 0, a
(2, 16) batch of tokens and targets from `np.random.default_rng(0)`,
`eigsh(op, 4, block_size=2, tol=1e-3, max_restarts=40, which="LA")`.
Runs on the CUDA card (the flash forward and backward kernels inside
each product, gram and tsgemm in the solve) unless `--device cpu`.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import HvpOperator, eigsh
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


def hessian_operator(cfg, *, device=None, seed: int = 0, params=None,
                     batch_shape=(2, 16)) -> HvpOperator:
    """The Hessian of `cfg`'s mean cross entropy on one batch of tokens
    and targets drawn (in that order) from `np.random.default_rng(0)`.
    The parameters are `params` when given, else `cfg`'s model drawn
    from `seed` on the device."""
    dev = resolve_device(device)
    if params is None:
        params = tf.init_model(seed, cfg, device=dev)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, batch_shape), dtype=torch.int32,
            device=dev),
        "targets": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, batch_shape), dtype=torch.int32,
            device=dev),
    }

    def loss(p):
        return tf.loss_fn(p, cfg, batch, device=dev)

    return HvpOperator(loss, params, pad_to=8, device=dev)


def main(config: str = "qwen2-1.5b", *, device=None, params=None, x0=None):
    """Solve for the top 4 Hessian eigenvalues of reduced `config`;
    `x0` is an explicit (n, 2) start block (a parity test passes the
    reference's draw). Returns the `EigResult`."""
    cfg = configs.reduced(config)
    op = hessian_operator(cfg, device=device, params=params)
    print(f"parameter space dimension: {op.n_logical:,}")
    res = eigsh(op, 4, block_size=2, tol=1e-3, max_restarts=40,
                which="LA", x0=x0)
    print("top Hessian eigenvalues:", np.round(res.eigenvalues, 4))
    print(f"restarts={res.n_restarts} HVP-block-calls={res.n_ops}")
    assert np.isfinite(res.eigenvalues).all()
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=configs.ARCHS,
                    help="architecture, at its reduced size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(args.arch, device=args.device)
