"""Host int <-> limb-array conversion helpers (the port's own copy of
zk_toolkit_tpu/utils/bigint.py).

A field element is a vector of K 16-bit limbs, little-endian. The port
stores the limbs as int32 (values stay below 2^16, so the sign bit is never
set); the host-side arrays made here are uint32, as in the JAX package, and
convert.py / the pack helpers move them onto a device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def num_limbs(nbits: int) -> int:
    """Limb count for an `nbits`-bit modulus."""
    return max(1, (nbits + LIMB_BITS - 1) // LIMB_BITS)


def int_to_limbs(x: int, k: int) -> list[int]:
    """Little-endian base-2^16 decomposition, exactly k limbs."""
    if x < 0:
        raise ValueError("negative")
    out = []
    for _ in range(k):
        out.append(x & LIMB_MASK)
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit in k limbs")
    return out


def limbs_to_int(limbs: Sequence[int]) -> int:
    x = 0
    for i, l in enumerate(limbs):
        x += int(l) << (LIMB_BITS * i)
    return x


def ints_to_array(xs: Sequence[int], k: int) -> np.ndarray:
    """Batch of ints -> uint32 ndarray of shape (len(xs), k): the limbs of
    int_to_limbs, through one little-endian byte string per int."""
    try:
        buf = b"".join(int(x).to_bytes(2 * k, "little") for x in xs)
    except OverflowError as e:
        raise ValueError(f"value negative or wider than {k} limbs") from e
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), k).astype(np.uint32)


def array_to_ints(a) -> list[int]:
    """Integer array (..., k) -> list of ints over the leading axes (flattened)."""
    a = np.asarray(a).astype(np.uint64)
    flat = a.reshape(-1, a.shape[-1])
    return [limbs_to_int(row) for row in flat]
