"""AST -> flat list of a*b = c gates.

(The port's own copy of zk_toolkit_tpu/snark/gate.py;
the port imports nothing of the JAX package.)

Parity: reference zk/w_trusted_setup/qap/gate.rs:7-79 — lowering rules:
Add(a,b)=t  -> (a+b)*1 = t; Sub(a,b)=t -> (b+t)*1 = a; Div(a,b)=t -> b*t = a;
Mul(a,b)=t  -> a*b = t; final gate root*1 = Out (:72-78).
"""

from __future__ import annotations

from dataclasses import dataclass

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField
from zk_toolkit_tpu_torch.snark import term as T
from zk_toolkit_tpu_torch.snark.equation_parser import (
    Equation, MathExpr, NumExpr, VarExpr, Add, Sub, Mul, Div,
)


@dataclass
class Gate:
    a: T.Term
    b: T.Term
    c: T.Term

    def __repr__(self):
        return f"{self.a!r} * {self.b!r} = {self.c!r}"


def _traverse(f: PrimeField, expr: MathExpr, gates: list[Gate]) -> T.Term:
    if isinstance(expr, NumExpr):
        return T.Num(expr.n)
    if isinstance(expr, VarExpr):
        return T.Var(expr.name)
    if isinstance(expr, Add):
        a = _traverse(f, expr.left, gates)
        b = _traverse(f, expr.right, gates)
        c = T.TmpVar(expr.signal_id)
        gates.append(Gate(T.Sum(a, b), T.One(), c))
        return c
    if isinstance(expr, Mul):
        a = _traverse(f, expr.left, gates)
        b = _traverse(f, expr.right, gates)
        c = T.TmpVar(expr.signal_id)
        gates.append(Gate(a, b, c))
        return c
    if isinstance(expr, Sub):
        # a - b = c  ->  (b + c) * 1 = a
        a = _traverse(f, expr.left, gates)
        b = _traverse(f, expr.right, gates)
        c = T.TmpVar(expr.signal_id)
        gates.append(Gate(T.Sum(b, c), T.One(), a))
        return c
    if isinstance(expr, Div):
        # a / b = c  ->  b * c = a
        a = _traverse(f, expr.left, gates)
        b = _traverse(f, expr.right, gates)
        c = T.TmpVar(expr.signal_id)
        gates.append(Gate(b, c, a))
        return c
    raise TypeError(f"unexpected expr node: {expr!r}")


def build(f: PrimeField, eq: Equation) -> list[Gate]:
    gates: list[Gate] = []
    root = _traverse(f, eq.lhs, gates)
    gates.append(Gate(root, T.One(), T.Out()))
    return gates
