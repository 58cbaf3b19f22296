"""Moves state between the JAX package's arrays and the port's tensors, so
both compute on the same inputs.

The JAX package holds limbs as uint32 arrays [..., K] (values < 2^16); the
port holds the same limbs as int32 tensors. Anything numpy can read goes in
(a jax.Array converts through np.asarray without this module importing JAX);
numpy arrays come out.
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
