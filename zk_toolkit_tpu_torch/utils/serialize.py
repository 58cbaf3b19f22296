"""Persistence of the Groth16 CRS (the port of
zk_toolkit_tpu/utils/serialize.py, over torch tensors).

The file format is the JAX package's: one compressed .npz whose keys are
`field.i` for the i-th tensor of a point tuple (and `field` for a bare
tensor), limbs stored as uint32. A CRS saved by either package loads in the
other with equal limbs. The circuit matrices are not stored: they derive
from the circuit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from zk_toolkit_tpu_torch import resolve_device


def _to_np(t: torch.Tensor) -> np.ndarray:
    """Limbs (int32 tensor) -> uint32, as the JAX package stores them;
    other dtypes (masks) as they are."""
    arr = t.detach().cpu().numpy()
    return arr.astype(np.uint32) if arr.dtype == np.int32 else arr


def _from_np(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """uint32 limbs -> int32 tensor (refusing values of 2^16 and more);
    other dtypes as they are."""
    if arr.dtype == np.uint32:
        if arr.size and int(arr.max()) >> 16:
            raise ValueError("limb values must be < 2^16")
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _flatten_crs(crs) -> dict:
    out = {}
    for f in dataclasses.fields(crs):
        v = getattr(crs, f.name)
        if isinstance(v, tuple) and all(isinstance(a, torch.Tensor) for a in v):
            for i, a in enumerate(v):
                out[f"{f.name}.{i}"] = _to_np(a)
        elif isinstance(v, torch.Tensor):
            out[f.name] = _to_np(v)
    return out


def save_crs(path: str, crs) -> None:
    """Write a protocols.groth16_device.DeviceCRS to an .npz file."""
    np.savez_compressed(path, **_flatten_crs(crs))


def load_crs(path: str, mat, device="cuda"):
    """Read a DeviceCRS saved with save_crs (by either package) onto
    `device`; `mat` must be the CircuitMatrices of the same circuit."""
    from zk_toolkit_tpu_torch.protocols.groth16_device import DeviceCRS

    dev = resolve_device(device)
    kwargs = {"mat": mat}
    parts = {}
    with np.load(path) as data:
        for key in data.files:
            if "." in key:
                base, idx = key.rsplit(".", 1)
                parts.setdefault(base, {})[int(idx)] = _from_np(data[key], dev)
            else:
                kwargs[key] = _from_np(data[key], dev)
    for base, ts in parts.items():
        kwargs[base] = tuple(ts[i] for i in sorted(ts))
    names = {f.name for f in dataclasses.fields(DeviceCRS)}
    return DeviceCRS(**{k: v for k, v in kwargs.items() if k in names})
