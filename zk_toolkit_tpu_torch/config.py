"""Curve/field registry and runtime configuration (the port of
zk_toolkit_tpu/config.py; the port imports nothing of the JAX package).

The reference hardcodes every parameter in lazy statics scattered across
files (secp256k1/affine_point.rs:30-47, bls12_381/params.rs:8-17,
curve25519/affine_point.rs:41-53); this is the central registry that binds
the host curves to the device field specs (ops/limbs.field_spec).

Environment knob, the JAX package's name:
- ZKT_PROFILE_DIR: when set, utils/profiling.trace() writes torch.profiler
  traces here

The device is chosen by each entry point's `device` argument
(zk_toolkit_tpu_torch.resolve_device), not by an environment variable.
"""

from __future__ import annotations

import dataclasses
import functools
import os


@dataclasses.dataclass(frozen=True)
class CurveInfo:
    """Static description of one curve family."""

    name: str
    base_modulus: int          # coordinate field p
    group_order: int           # scalar field / subgroup order r
    generator: tuple           # affine generator coords (ints; Fq2 as pairs)
    kind: str                  # "weierstrass-b" | "edwards" | "bls12-pairing"
    b: int | tuple | None = None

    @property
    def limbs(self) -> int:
        from zk_toolkit_tpu_torch.utils.bigint import num_limbs

        return num_limbs(self.base_modulus.bit_length())

    def field_spec(self):
        """Device-tier Montgomery spec for the coordinate field."""
        from zk_toolkit_tpu_torch.ops import limbs as L

        return L.field_spec(self.base_modulus)

    def scalar_spec(self):
        from zk_toolkit_tpu_torch.ops import limbs as L

        return L.field_spec(self.group_order)


@functools.lru_cache(maxsize=1)
def registry() -> dict:
    from zk_toolkit_tpu_torch.curves import curve25519, secp256k1
    from zk_toolkit_tpu_torch.curves.bls12_381 import g1 as bg1
    from zk_toolkit_tpu_torch.curves.bls12_381 import params as bls

    sec = CurveInfo(
        name="secp256k1",
        base_modulus=secp256k1.P,
        group_order=secp256k1.N,
        generator=(secp256k1.GX, secp256k1.GY),
        kind="weierstrass-b",
        b=7,
    )
    ed = CurveInfo(
        name="curve25519",
        base_modulus=curve25519.Q,
        group_order=curve25519.L,
        generator=(),  # derived: x recovered from y = 4/5 (RFC 8032)
        kind="edwards",
    )
    bls_g1 = CurveInfo(
        name="bls12_381_g1",
        base_modulus=bls.Q,
        group_order=bls.R,
        generator=(bg1.GX, bg1.GY),
        kind="bls12-pairing",
        b=4,
    )
    return {c.name: c for c in (sec, ed, bls_g1)}


def curve(name: str) -> CurveInfo:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown curve {name!r}; have {sorted(reg)}")
    return reg[name]


def profile_dir() -> str | None:
    return os.environ.get("ZKT_PROFILE_DIR") or None
