"""Wire-label terms for gates and R1CS.

(The port's own copy of zk_toolkit_tpu/snark/term.py;
the port imports nothing of the JAX package.)

Parity: reference zk/w_trusted_setup/qap/term.rs:5-13 — Num / One / Out /
Sum(a, b) / TmpVar(id) / Var(name). SignalId is a plain int
(reference qap/config.rs:1 `type SignalId = u128`).
"""

from __future__ import annotations

from dataclasses import dataclass

from zk_toolkit_tpu_torch.fields.prime_field import PrimeFieldElem


class Term:
    """Base class; subclasses are frozen dataclasses usable as dict keys."""

    __slots__ = ()


@dataclass(frozen=True)
class Num(Term):
    n: PrimeFieldElem

    def __repr__(self):
        return f"{self.n.e}"


@dataclass(frozen=True)
class One(Term):
    def __repr__(self):
        return "1"


@dataclass(frozen=True)
class Out(Term):
    def __repr__(self):
        return "out"


@dataclass(frozen=True)
class Sum(Term):
    a: Term
    b: Term

    def __repr__(self):
        return f"({self.a!r} + {self.b!r})"


@dataclass(frozen=True)
class TmpVar(Term):
    id: int

    def __repr__(self):
        return f"t{self.id}"


@dataclass(frozen=True)
class Var(Term):
    name: str

    def __repr__(self):
        return f"{self.name!r}"
