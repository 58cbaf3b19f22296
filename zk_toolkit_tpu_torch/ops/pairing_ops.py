"""G2 packing for the device (the port of zk_toolkit_tpu/ops/pairing_ops.py,
only what the Groth16 prove needs: `pack_g2_affine`; the Miller loop and
the final exponentiation come with the verify slice)."""

from __future__ import annotations

import numpy as np
import torch

from zk_toolkit_tpu_torch.utils.bigint import int_to_limbs


def _mont_np(v: int, spec) -> np.ndarray:
    return np.asarray(int_to_limbs(v * spec.r_mod_p % spec.p, spec.K), dtype=np.int32)


def pack_g2_affine(pts, spec, device="cuda") -> tuple:
    """Host G2 affine points (curves/bls12_381 AffinePoint over Fq2) ->
    (x, y, inf): int32 [n, 2, K] Montgomery tensors and bool [n] on
    `device`."""
    from zk_toolkit_tpu_torch import resolve_device

    n = len(pts)
    xs = np.zeros((n, 2, spec.K), dtype=np.int32)
    ys = np.zeros((n, 2, spec.K), dtype=np.int32)
    inf = np.zeros((n,), dtype=bool)
    for i, pt in enumerate(pts):
        if pt.is_zero():
            inf[i] = True
        else:
            xs[i, 0] = _mont_np(pt.x.u0.e, spec)
            xs[i, 1] = _mont_np(pt.x.u1.e, spec)
            ys[i, 0] = _mont_np(pt.y.u0.e, spec)
            ys[i, 1] = _mont_np(pt.y.u1.e, spec)
    dev = resolve_device(device)
    return (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev),
            torch.from_numpy(inf).to(dev))
