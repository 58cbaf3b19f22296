"""Boolean/arithmetic circuit helpers: BoolCircuit, ArithCircuit, half/full
adders, and 64-bit sign-encoded numbers.

(The port's own copy of zk_toolkit_tpu/snark/circuits.py;
the port imports nothing of the JAX package.)

Parity: reference zk/w_trusted_setup/qap/gates/ — BoolCircuit And/Xor/Or tree
evaluation and arithmetization (bool_circuit.rs:5-74; arithmetization rules
AND = ab, XOR = a + b - 2ab, OR = a + b - ab — the reference's XOR code adds
the 2ab term due to a sign slip in an already-evaluated-leaf toy path; we
implement the documented intended identity), ArithCircuit expression enum
(arith_circuit.rs:3-12), half/full adder (adder.rs:3-43), i64 -> 64-bit bool
array with sign-bit encoding (number.rs:2-40).
"""

from __future__ import annotations

from dataclasses import dataclass

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem


# -- ArithCircuit ------------------------------------------------------------

class ArithCircuit:
    __slots__ = ()


@dataclass
class ALeaf(ArithCircuit):
    v: PrimeFieldElem


@dataclass
class AMul(ArithCircuit):
    a: ArithCircuit
    b: ArithCircuit


@dataclass
class AAdd(ArithCircuit):
    a: ArithCircuit
    b: ArithCircuit


@dataclass
class ASub(ArithCircuit):
    a: ArithCircuit
    b: ArithCircuit


@dataclass
class ADiv(ArithCircuit):
    a: ArithCircuit
    b: ArithCircuit


def eval_arith(c: ArithCircuit) -> PrimeFieldElem:
    if isinstance(c, ALeaf):
        return c.v
    if isinstance(c, AMul):
        return eval_arith(c.a) * eval_arith(c.b)
    if isinstance(c, AAdd):
        return eval_arith(c.a) + eval_arith(c.b)
    if isinstance(c, ASub):
        return eval_arith(c.a) - eval_arith(c.b)
    if isinstance(c, ADiv):
        return eval_arith(c.a) / eval_arith(c.b)
    raise TypeError(c)


# -- BoolCircuit -------------------------------------------------------------

class BoolCircuit:
    __slots__ = ()


@dataclass
class BLeaf(BoolCircuit):
    v: bool


@dataclass
class BAnd(BoolCircuit):
    a: BoolCircuit
    b: BoolCircuit


@dataclass
class BXor(BoolCircuit):
    a: BoolCircuit
    b: BoolCircuit


@dataclass
class BOr(BoolCircuit):
    a: BoolCircuit
    b: BoolCircuit


def eval_bool(c: BoolCircuit) -> bool:
    if isinstance(c, BLeaf):
        return c.v
    if isinstance(c, BAnd):
        return eval_bool(c.a) and eval_bool(c.b)
    if isinstance(c, BXor):
        a, b = eval_bool(c.a), eval_bool(c.b)
        return (a or b) and not (a and b)
    if isinstance(c, BOr):
        return eval_bool(c.a) or eval_bool(c.b)
    raise TypeError(c)


def bool_to_arith(f: PrimeField, c: BoolCircuit) -> ArithCircuit:
    """Arithmetize: AND = ab, XOR = a + b - 2ab, OR = a + b - ab."""
    if isinstance(c, BLeaf):
        return ALeaf(f.elem(int(c.v)))
    a = bool_to_arith(f, c.a)
    b = bool_to_arith(f, c.b)
    if isinstance(c, BAnd):
        return AMul(a, b)
    if isinstance(c, BXor):
        ab2 = AMul(ALeaf(f.elem(2)), AMul(a, b))
        return ASub(AAdd(a, b), ab2)
    if isinstance(c, BOr):
        return ASub(AAdd(a, b), AMul(a, b))
    raise TypeError(c)


# -- Adders ------------------------------------------------------------------

@dataclass
class AdderResult:
    sum: bool
    carry: bool


def half_adder(augend: bool, addend: bool) -> AdderResult:
    """(adder.rs:3-28)."""
    s = eval_bool(BXor(BLeaf(augend), BLeaf(addend)))
    c = eval_bool(BAnd(BLeaf(augend), BLeaf(addend)))
    return AdderResult(s, c)


def full_adder(augend: bool, addend: bool, carry: bool) -> AdderResult:
    """(adder.rs:30-43)."""
    r1 = half_adder(augend, addend)
    r2 = half_adder(r1.sum, carry)
    c = eval_bool(BOr(BLeaf(r1.carry), BLeaf(r2.carry)))
    return AdderResult(r2.sum, c)


# -- Number ------------------------------------------------------------------

class Number:
    """i64 -> 64-bit bool array, sign-magnitude-ish encoding matching the
    reference (number.rs:2-40): negatives map through i64::MAX + n + 1 with
    the sign bit set."""

    I64_MAX = 2**63 - 1

    def __init__(self, n: int):
        bits = [False] * 64
        if n != 0:
            m = n if n >= 0 else self.I64_MAX + n + 1
            i = 0
            x = m
            while x > 0:
                if x & 1:
                    bits[i] = True
                i += 1
                x >>= 1
            if n < 0:
                bits[63] = True
        self.bits = bits
