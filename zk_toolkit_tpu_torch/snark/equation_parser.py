"""Equation-string parser: `<expr> == <number>` -> MathExpr AST.

(The port's own copy of zk_toolkit_tpu/snark/equation_parser.py;
the port imports nothing of the JAX package.)

Parity: reference zk/w_trusted_setup/qap/equation_parser.rs — grammar
(:204-207):

    <term2>    ::= <variable> | <number> | '(' <expr> ')'
    <term1>    ::= <term2> [ ('*'|'/') <term2> ]*
    <expr>     ::= <term1> [ ('+'|'-') <term1> ]*
    <equation> ::= <expr> '==' <number>

with monotonically increasing SignalIds per op node (:37-41), negative
literals via elem_from_signed (:44-52), and variables matching
`alpha1 [0-9]*`.

Operator-chain shape parity (equation_parser.rs:108-145, :148-185): for
`a op1 b op2 c ...` the reference folds the tail first — producing
`Op1(a, Op2(b, c))` — so chained '-'/'/' group to the RIGHT of the first
operator (e.g. `a - b - c` evaluates as a - (b - c)). We reproduce this
exactly, including the SignalId assignment order (tail fold first, outer
node last), since gate/R1CS layouts depend on it.
"""

from __future__ import annotations

from dataclasses import dataclass

from zk_toolkit_tpu_torch.fields.prime_field import PrimeField, PrimeFieldElem


class MathExpr:
    __slots__ = ()


@dataclass
class NumExpr(MathExpr):
    n: PrimeFieldElem


@dataclass
class VarExpr(MathExpr):
    name: str


@dataclass
class BinOp(MathExpr):
    signal_id: int
    left: MathExpr
    right: MathExpr


class Add(BinOp):
    pass


class Sub(BinOp):
    pass


class Mul(BinOp):
    pass


class Div(BinOp):
    pass


@dataclass
class Equation:
    lhs: MathExpr
    rhs: PrimeFieldElem


class ParseError(ValueError):
    pass


class EquationParser:
    """Recursive-descent parser with the reference's exact grammar and
    signal-id numbering."""

    def __init__(self, f: PrimeField, text: str):
        self.f = f
        self.text = text
        self.pos = 0
        self.signal_id = 0

    # -- lexing helpers -----------------------------------------------------
    def _ws(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _next_id(self) -> int:
        self.signal_id += 1
        return self.signal_id

    # -- grammar ------------------------------------------------------------
    def _variable(self) -> MathExpr | None:
        self._ws()
        start = self.pos
        if not self._peek().isalpha():
            return None
        while self._peek().isalpha():
            self.pos += 1
        while self._peek().isdigit():
            self.pos += 1
        name = self.text[start:self.pos]
        self._ws()
        return VarExpr(name)

    def _decimal(self) -> MathExpr | None:
        self._ws()
        start = self.pos
        if self._peek() == "-":
            self.pos += 1
        if not self._peek().isdigit():
            self.pos = start
            return None
        while self._peek().isdigit():
            self.pos += 1
        s = self.text[start:self.pos]
        self._ws()
        return NumExpr(self.f.elem_from_signed(int(s)))

    def _term2(self) -> MathExpr:
        v = self._variable()
        if v is not None:
            return v
        d = self._decimal()
        if d is not None:
            return d
        self._ws()
        if self._peek() == "(":
            self.pos += 1
            e = self._expr()
            self._ws()
            if self._peek() != ")":
                raise ParseError(f"expected ')' at {self.pos}")
            self.pos += 1
            self._ws()
            return e
        raise ParseError(f"expected term at {self.pos}: {self.text[self.pos:self.pos+20]!r}")

    def _chain(self, sub_parser, ops: dict[str, type]) -> MathExpr:
        lhs = sub_parser()
        pairs: list[tuple[str, MathExpr]] = []
        while True:
            self._ws()
            ch = self._peek()
            # don't treat '==' as an operator boundary issue: ops are single chars
            if ch in ops and not (ch == "=" ):
                self.pos += 1
                pairs.append((ch, sub_parser()))
            else:
                break
        if not pairs:
            return lhs
        # reference fold: start from pairs[0]'s operand, fold pairs[1:] with
        # their own ops, then join lhs with pairs[0]'s op as the outer node
        acc = pairs[0][1]
        for op, node in pairs[1:]:
            acc = ops[op](self._next_id(), acc, node)
        return ops[pairs[0][0]](self._next_id(), lhs, acc)

    def _term1(self) -> MathExpr:
        return self._chain(self._term2, {"*": Mul, "/": Div})

    def _expr(self) -> MathExpr:
        return self._chain(self._term1, {"+": Add, "-": Sub})

    def _equation(self) -> Equation:
        self._ws()
        lhs = self._expr()
        self._ws()
        if self.text[self.pos:self.pos + 2] != "==":
            raise ParseError(f"expected '==' at {self.pos}")
        self.pos += 2
        rhs = self._decimal()
        if rhs is None:
            raise ParseError("equation RHS must be a number")
        self._ws()
        if self.pos != len(self.text):
            raise ParseError(f"trailing input at {self.pos}")
        return Equation(lhs, rhs.n)

    @staticmethod
    def parse(f: PrimeField, text: str) -> Equation:
        return EquationParser(f, text)._equation()
