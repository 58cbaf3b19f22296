"""Moves state between the JAX package's arrays and the port's tensors, so
both compute on the same inputs.

The JAX package holds limbs as uint32 arrays [..., K] (values < 2^16); the
port holds the same limbs as int32 tensors. K is whatever the array has:
24 for BLS12-381 Fq, 16 for Fr, for secp256k1 coordinates ([N, 16]
Jacobian point tuples) and for Fr(n) scalar vectors (the Bulletproofs and
ECDSA limbs). Anything numpy can read goes in (a jax.Array converts
through np.asarray without this module importing JAX); numpy arrays come
out.
"""

from __future__ import annotations

import numpy as np
import torch

from zk_toolkit_tpu_torch import resolve_device


def limbs_from_jax(a, device="cuda") -> torch.Tensor:
    """uint32 limb array [..., K] -> int32 tensor on `device`."""
    arr = np.asarray(a)
    if arr.dtype != np.uint32:
        raise ValueError(f"expected uint32 limbs, got {arr.dtype}")
    if arr.size and int(arr.max()) >> 16:
        raise ValueError("limb values must be < 2^16")
    return torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device))


def limbs_to_jax(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array (what jnp.asarray takes)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def points_from_jax(p, device="cuda") -> tuple:
    """Jacobian point tuple (x, y, z) of uint32 [..., K] arrays -> tensors."""
    return tuple(limbs_from_jax(a, device) for a in p)


def points_to_jax(p) -> tuple:
    return tuple(limbs_to_jax(a) for a in p)


def scalars_from_jax(s, device="cuda") -> torch.Tensor:
    """uint32 [N, 16] plain scalar limbs -> int32 tensor."""
    return limbs_from_jax(s, device)


def table_from_jax(table, device="cuda") -> tuple:
    """Fixed-base table (ax, ay, inf) -> (int32, int32, bool) tensors."""
    ax, ay, inf = table
    return (limbs_from_jax(ax, device), limbs_from_jax(ay, device),
            torch.from_numpy(np.asarray(inf).astype(bool)).to(resolve_device(device)))


def table_to_jax(table) -> tuple:
    ax, ay, inf = table
    return (limbs_to_jax(ax), limbs_to_jax(ay), inf.detach().cpu().numpy().astype(bool))


MATRIX_ARRAYS = ("a_idx", "b_idx", "c_idx", "a_val", "b_val", "c_val")
CRS_POINTS = ("g1_alpha", "g1_beta", "g1_delta", "g2_beta", "g2_gamma", "g2_delta",
              "g1_u", "g1_v", "g2_v", "g1_uvw_stmt", "g1_uvw_wit", "g1_xt")


def matrices_from_jax(mat, tmpl, device="cuda"):
    """The JAX package's CircuitMatrices -> the port's, on `device`: its
    sizes and its arrays (int32 wire indices, uint32 Montgomery limbs; numpy
    arrays or anything np.asarray reads), bound to the port's host template
    `tmpl` of the same circuit (which the CRS and the prover read)."""
    from zk_toolkit_tpu_torch.protocols.groth16_device import CircuitMatrices

    dev = resolve_device(device)
    arrays = {}
    for name in MATRIX_ARRAYS:
        arr = np.asarray(getattr(mat, name))
        if name.endswith("_idx"):
            if arr.dtype != np.int32:
                raise ValueError(f"{name}: expected int32 wire indices, got {arr.dtype}")
            arrays[name] = torch.from_numpy(arr.copy()).to(dev)
        else:
            arrays[name] = limbs_from_jax(arr, dev)
    return CircuitMatrices(n=mat.n, n_pad=mat.n_pad, m=mat.m, l=mat.l, kmax=mat.kmax,
                           tmpl=tmpl, **arrays)


def crs_from_jax(crs, mat, device="cuda"):
    """The JAX package's DeviceCRS (its Jacobian point tuples of uint32
    limb arrays, [n, K] for G1 and [n, 2, K] for G2) -> the port's, for the
    port's CircuitMatrices `mat` of the same circuit."""
    from zk_toolkit_tpu_torch.protocols.groth16_device import DeviceCRS

    return DeviceCRS(mat=mat, **{name: points_from_jax(getattr(crs, name), device)
                                 for name in CRS_POINTS})
