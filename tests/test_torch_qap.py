"""The port's host polynomial / QAP / circuit tier against the JAX
package's: zk_toolkit_tpu_torch/fields/polynomial.py (arithmetic,
divide_by, the evaluations), snark/qap.py (build_polynomial, build_t, QAP
on the flagship R1CS), snark/circuits.py, SparseMatrix.to_polynomials and
the params accessors. Inputs from `random` seeds; tolerance 0 (equal ints).
"""

from __future__ import annotations

import random

import pytest

from zk_toolkit_tpu.curves.bls12_381 import params as JP
from zk_toolkit_tpu.fields.polynomial import Polynomial as JPoly
from zk_toolkit_tpu.fields.prime_field import PrimeField as JField
from zk_toolkit_tpu.fields.sparse_matrix import SparseMatrix as JMatrix
from zk_toolkit_tpu.snark import circuits as JC
from zk_toolkit_tpu.snark import gate as jgate
from zk_toolkit_tpu.snark import qap as jqap
from zk_toolkit_tpu.snark import term as JT
from zk_toolkit_tpu.snark.equation_parser import EquationParser as JParser
from zk_toolkit_tpu.snark.r1cs import R1CS as JR1CS
from zk_toolkit_tpu.snark.r1cs import R1CSTmpl as JTmpl
from zk_toolkit_tpu_torch.curves.bls12_381 import params as TP
from zk_toolkit_tpu_torch.fields.polynomial import Polynomial as TPoly
from zk_toolkit_tpu_torch.fields.prime_field import PrimeField as TField
from zk_toolkit_tpu_torch.fields.sparse_matrix import SparseMatrix as TMatrix
from zk_toolkit_tpu_torch.snark import circuits as TC
from zk_toolkit_tpu_torch.snark import gate as tgate
from zk_toolkit_tpu_torch.snark import qap as tqap
from zk_toolkit_tpu_torch.snark import term as TT
from zk_toolkit_tpu_torch.snark.equation_parser import EquationParser as TParser
from zk_toolkit_tpu_torch.snark.r1cs import R1CS as TR1CS
from zk_toolkit_tpu_torch.snark.r1cs import R1CSTmpl as TTmpl

FLAGSHIP = "(x * x * x) + x + 5 == 35"
FLAGSHIP_VALUES = ((lambda T: T.One(), 1), (lambda T: T.Var("x"), 3), (lambda T: T.Out(), 35),
                   (lambda T: T.TmpVar(1), 9), (lambda T: T.TmpVar(2), 27),
                   (lambda T: T.TmpVar(3), 8), (lambda T: T.TmpVar(4), 35))


def ints(poly) -> list[int]:
    return [c.e for c in poly.coeffs]


def _polys(p: int, seed: int, n: int = 6):
    rng = random.Random(seed)
    cs = [[rng.randrange(p) for _ in range(rng.randrange(1, 9))] for _ in range(n)]
    cs.append([0, 0, 0])                      # the zero polynomial, normalized
    cs.append([5, 0, 0])                      # a constant with trailing zeros
    return cs


@pytest.mark.parametrize("p", (97, JP.R), ids=("p97", "bls_r"))
def test_polynomial_arithmetic_equals_jax(p):
    jf, tf = JField(p), TField(p)
    cs = _polys(p, seed=p % 1000)
    for a in cs:
        for b in cs:
            ja, jb, ta, tb = JPoly(jf, a), JPoly(jf, b), TPoly(tf, a), TPoly(tf, b)
            assert ints(ta + tb) == ints(ja + jb)
            assert ints(ta - tb) == ints(ja - jb)
            assert ints(ta * tb) == ints(ja * jb)
            assert ints(-ta) == ints(-ja)
            assert ints(ta * tf.elem(7)) == ints(ja * jf.elem(7))
            if tb.is_zero():
                with pytest.raises(ZeroDivisionError):
                    ta.divide_by(tb)
                continue
            jr, tr = ja.divide_by(jb), ta.divide_by(tb)
            assert ints(tr.quotient) == ints(jr.quotient)
            assert tr.is_exact == jr.is_exact
            if not tr.is_exact:
                assert ints(tr.remainder) == ints(jr.remainder)
            assert (ta * tb).divide_by(tb).is_exact
        ta, ja = TPoly(tf, a), JPoly(jf, a)
        assert ta.degree() == ja.degree()
        assert [e.e for e in ta.eval_from_1_to_n(5)] == [e.e for e in ja.eval_from_1_to_n(5)]
        assert ta.eval_at(123456).e == ja.eval_at(123456).e
        assert [e.e for e in ta.to_sparse_vec(10).to_dense()] == \
            [e.e for e in ja.to_sparse_vec(10).to_dense()]


def test_polynomial_hidings_sum_equals_jax():
    """eval_with_g1_hidings over plain ints standing in for points (any
    type with + and * by a field element): sum_i c_i * P_i."""
    p = 101
    jf, tf = JField(p), TField(p)
    coeffs = [3, 0, 7, 1]
    powers = [2, 5, 11, 13, 17]
    got = TPoly(tf, coeffs).eval_with_g1_hidings([tf.elem(x) for x in powers])
    want = JPoly(jf, coeffs).eval_with_g1_hidings([jf.elem(x) for x in powers])
    assert got.e == want.e == sum(c * x for c, x in zip(coeffs, powers)) % p
    with pytest.raises(ValueError):
        TPoly(tf, coeffs).eval_with_g2_hidings([tf.elem(1)])


def _flagship(field, T, Parser, gate_mod, Tmpl, R1CS_):
    eq = Parser.parse(field, FLAGSHIP)
    tmpl = Tmpl(field, gate_mod.build(field, eq))
    wit = {make(T): field.elem(v) for make, v in FLAGSHIP_VALUES}
    return tmpl, R1CS_.from_tmpl(field, tmpl, wit)


def test_qap_on_the_flagship_r1cs_equals_jax():
    jf, tf = JP.SUBGROUP, TP.SUBGROUP
    jtmpl, jr = _flagship(jf, JT, JParser, jgate, JTmpl, JR1CS)
    ttmpl, tr = _flagship(tf, TT, TParser, tgate, TTmpl, TR1CS)
    jq, tq = jqap.QAP.build(jf, jr), tqap.QAP.build(tf, tr)
    n = len(ttmpl.constraints)
    assert tq.num_constraints == jq.num_constraints == n == len(jtmpl.constraints)
    for side in ("vi", "wi", "yi"):
        assert [ints(x) for x in getattr(tq, side)] == [ints(x) for x in getattr(jq, side)]
    assert ints(tq.build_p(tr.witness)) == ints(jq.build_p(jr.witness))
    assert tq.is_valid(tr.witness, n) and jq.is_valid(jr.witness, n)
    assert ints(tqap.build_t(tf, n)) == ints(jqap.build_t(jf, n))
    # a wrong witness (x = 4): p is no longer divisible by t
    from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec as TVec

    bad = TVec.from_dense(tf, [e.e for e in tr.witness.to_dense()])
    bad.set(1, tf.elem(4))
    assert not tq.is_valid(bad, n)


def test_build_polynomial_hits_its_targets():
    rng = random.Random(11)
    p = 1009
    jf, tf = JField(p), TField(p)
    from zk_toolkit_tpu.fields.sparse_vec import SparseVec as JVec
    from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec as TVec

    vals = [rng.randrange(p) for _ in range(6)]
    vals[2] = 0
    tpoly = tqap.build_polynomial(tf, TVec.from_dense(tf, vals))
    jpoly = jqap.build_polynomial(jf, JVec.from_dense(jf, vals))
    assert ints(tpoly) == ints(jpoly)
    assert [tpoly.eval_at(i + 1).e for i in range(6)] == vals


def test_circuits_equal_jax():
    for a in (False, True):
        for b in (False, True):
            th, jh = TC.half_adder(a, b), JC.half_adder(a, b)
            assert (th.sum, th.carry) == (jh.sum, jh.carry)
            for carry in (False, True):
                tfa, jfa = TC.full_adder(a, b, carry), JC.full_adder(a, b, carry)
                assert (tfa.sum, tfa.carry) == (jfa.sum, jfa.carry)
                assert int(tfa.sum) + 2 * int(tfa.carry) == int(a) + int(b) + int(carry)
    for n in (0, 1, 5, -1, -5, 2**62, -(2**62), 2**63 - 1):
        assert TC.Number(n).bits == JC.Number(n).bits
    f, jf = TField(97), JField(97)
    for a in (False, True):
        for b in (False, True):
            for top, jop in ((TC.BAnd, JC.BAnd), (TC.BXor, JC.BXor), (TC.BOr, JC.BOr)):
                c = top(TC.BLeaf(a), TC.BLeaf(b))
                jc = jop(JC.BLeaf(a), JC.BLeaf(b))
                assert TC.eval_bool(c) == JC.eval_bool(jc)
                assert TC.eval_arith(TC.bool_to_arith(f, c)).e == \
                    JC.eval_arith(JC.bool_to_arith(jf, jc)).e == int(JC.eval_bool(jc))
    expr = TC.ADiv(TC.AAdd(TC.ALeaf(f.elem(3)), TC.AMul(TC.ALeaf(f.elem(4)), TC.ALeaf(f.elem(5)))),
                   TC.ASub(TC.ALeaf(f.elem(9)), TC.ALeaf(f.elem(2))))
    jexpr = JC.ADiv(JC.AAdd(JC.ALeaf(jf.elem(3)),
                            JC.AMul(JC.ALeaf(jf.elem(4)), JC.ALeaf(jf.elem(5)))),
                    JC.ASub(JC.ALeaf(jf.elem(9)), JC.ALeaf(jf.elem(2))))
    assert TC.eval_arith(expr).e == JC.eval_arith(jexpr).e == 23 * pow(7, -1, 97) % 97
    with pytest.raises(TypeError):
        TC.eval_bool(TC.BoolCircuit())


def test_to_polynomials_equals_jax():
    p = 211
    rng = random.Random(5)
    rows = [[rng.randrange(p) if rng.random() < 0.6 else 0 for _ in range(5)] for _ in range(4)]
    tm, jm = TMatrix(TField(p), 5, 4), JMatrix(JField(p), 5, 4)
    for y, row in enumerate(rows):
        for x, v in enumerate(row):
            if v:
                tm.set(x, y, TField(p).elem(v))
                jm.set(x, y, JField(p).elem(v))
    tp, jp = tm.to_polynomials(), jm.to_polynomials()
    assert len(tp) == 4
    assert [ints(a) for a in tp] == [ints(b) for b in jp]


def test_params_accessors_equal_jax():
    assert TP.base_prime_field().order == JP.base_prime_field().order == JP.Q
    assert TP.subgroup().order == JP.subgroup().order == JP.R
    assert TP.embedding_degree() == JP.embedding_degree() == 12
    assert TP.base_prime_field() is TP.BASE_PRIME_FIELD and TP.subgroup() is TP.SUBGROUP
