"""Device Groth16 — for now only its fixed-base G1 path (the port of
zk_toolkit_tpu/protocols/groth16_device.py:164-188), which makes the
distinct points k_i * G of the MSM benchmark. The prove itself is the next
slice of the port.
"""

from __future__ import annotations

import functools

import torch

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import fixed_base as FB
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops.field_ops import FqOps

R = params.R
FR_BITS = 256  # scalar limb width for MSM digit extraction (16 limbs)
FB_WINDOW = 8  # fixed-base window bits (table = 32 windows x 256 entries)


def _fq_ops() -> FqOps:
    return FqOps(L.field_spec(params.Q))


@functools.lru_cache(maxsize=None)
def _g1_base(device: str):
    return C.pack_points([(params.G1_X, params.G1_Y)], _fq_ops().spec, device=device)


@functools.lru_cache(maxsize=None)
def _g1_table(device: str):
    return FB.build_table(_fq_ops(), _g1_base(device), FR_BITS, FB_WINDOW)


def fixed_base_g1(scalars_plain: torch.Tensor):
    """[k_i * G1] batched: windowed table gathers + a log-depth add tree,
    on the device of `scalars_plain` (int32 [B, 16] plain limbs)."""
    return FB.scalar_mul_fixed(
        _fq_ops(), _g1_table(str(scalars_plain.device)), scalars_plain, FB_WINDOW
    )
