"""Synthetic R1CS instances for benchmarks and the multichip dryrun.

(The port's own copy of zk_toolkit_tpu/snark/synthetic.py;
the port imports nothing of the JAX package.)

Builds a genuine R1CSTmpl (same object the equation-parser frontend
produces — reference zk/w_trusted_setup/qap/r1cs_tmpl.rs:13-137 layout
[1, inputs..., Out, mid...]) of arbitrary constraint count, so large-scale
Groth16/Pinocchio benchmarks exercise the public prover API instead of
hand-rolled matrix stand-ins. The circuit shape follows the reference's
gate form (gate.rs:24-70): every constraint is (w_i + 2*w_j) * w_k = t,
with a final root*1 = Out gate (gate.rs:72-78).
"""

from __future__ import annotations

import numpy as np

from zk_toolkit_tpu_torch.fields.sparse_vec import SparseVec
from zk_toolkit_tpu_torch.snark import term as T
from zk_toolkit_tpu_torch.snark.r1cs import Constraint, R1CSTmpl


def synthetic_r1cs(f, n_constraints: int, seed: int = 0,
                   pad_wires_to: int = 1):
    """(tmpl, witness_map): a valid R1CS with n_constraints constraints.

    Wire layout: [1, x, Out, t_1 .. t_{n-1}, zero-padding mids] — statement
    size l = 2. `pad_wires_to` appends unused zero-valued mid wires until the
    wire count is a multiple of it (so CRS point streams shard evenly over a
    device mesh).
    """
    assert n_constraints >= 2
    rng = np.random.default_rng(seed)
    p = f.order

    terms = [T.One(), T.Var("x"), T.Out()]
    vals = [1, int(rng.integers(2, 1 << 61)), 0]
    # one fresh mid wire per random gate
    n_rand = n_constraints - 1
    rows = []
    for k in range(n_rand):
        # Sample operands from every live wire EXCEPT index 2 (Out): its value
        # is only fixed by the final root gate below, so a gate reading it
        # before then would bind the pre-patch placeholder and invalidate the
        # R1CS (this exact bug broke every n >= ~64 instance in round 2).
        hi = len(vals) - 1
        a1, a2, b1 = (int(x) if x < 2 else int(x) + 1
                      for x in rng.integers(0, hi, size=3))
        av = (vals[a1] + 2 * vals[a2]) % p
        cv = av * vals[b1] % p
        terms.append(T.TmpVar(k + 1))
        vals.append(cv)
        acoef = {a1: 1}
        acoef[a2] = acoef.get(a2, 0) + 2   # a1 == a2 -> one 3x entry
        rows.append((tuple(acoef.items()), ((b1, 1),), ((len(vals) - 1, 1),)))
    # final gate: t_last * 1 = Out (root gate, reference gate.rs:72-78)
    root = len(vals) - 1
    vals[2] = vals[root]
    rows.append((((root, 1),), ((0, 1),), ((2, 1),)))

    while len(vals) % pad_wires_to:
        terms.append(T.TmpVar(len(vals)))
        vals.append(0)

    m = len(vals)
    tmpl = object.__new__(R1CSTmpl)
    tmpl.f = f
    tmpl.witness = terms
    tmpl.indices = {t: i for i, t in enumerate(terms)}
    tmpl.mid_beg = 3
    tmpl.constraints = []
    for arow, brow, crow in rows:
        vecs = []
        for side in (arow, brow, crow):
            v = SparseVec(f, m)
            for idx, coeff in side:
                v.set(idx, coeff)
            vecs.append(v)
        tmpl.constraints.append(Constraint(*vecs))

    witness_map = {t: f.elem(v) for t, v in zip(terms, vals)}
    return tmpl, witness_map
