"""The Fenwick engine of zk_toolkit_tpu_torch/ops/msm.py on the stream
shapes where its index arithmetic has edge cases, on the CPU (plain
versions):

- msm_pippenger equals the host oracle in affine ints at n = 1, n = 2, odd
  n and window groups of several windows (W > 1);
- msm_pippenger_many on a batch of streams padded to a power of two;
- _msm_window on digit rows whose keys are all equal, all zero, all the
  largest digit, all distinct or in runs (boundary positions 0, N and
  repeated ones): each window's sum_b b * B_b equals the host's.

Inputs from `random` seeds; tolerance 0.
"""

from __future__ import annotations

import random

import pytest
import torch

from zk_toolkit_tpu_torch.curves.bls12_381 import params
from zk_toolkit_tpu_torch.ops import curve_ops as C
from zk_toolkit_tpu_torch.ops import limbs as L
from zk_toolkit_tpu_torch.ops import msm as M
from zk_toolkit_tpu_torch.ops.field_ops import FqOps
from zk_toolkit_tpu_torch.utils import host_curve as HC

R = params.R
SPEC = L.field_spec(params.Q)
OPS = FqOps(SPEC)


def _points(ks):
    return C.pack_points([HC.g1_mul_affine(k) for k in ks], SPEC, device="cpu")


def _oracle(ks, ss):
    total = sum(k * s for k, s in zip(ks, ss)) % R
    return HC.g1_mul_affine(total) if total else None


@pytest.mark.parametrize("n, c, nbits", ((1, 2, 8), (2, 2, 8), (7, 2, 8), (13, 4, 16),
                                         (32, 8, 16)),
                         ids=("n1", "n2", "n7", "n13_c4", "n32_c8"))
def test_msm_equals_the_host(n, c, nbits):
    rng = random.Random(n)
    ks = [rng.randrange(1, R) for _ in range(n)]
    ss = [rng.randrange(1 << nbits) for _ in range(n)]
    got = M.msm_pippenger(OPS, _points(ks), C.pack_scalars(ss, nbits, device="cpu"), nbits, c=c)
    assert C.unpack_points(tuple(a[None] for a in got), SPEC)[0] == _oracle(ks, ss)


def test_msm_many_on_a_batch_of_streams():
    """3 streams of 5 points, padded to 8: every (stream, window) pair a
    digit column of one pass."""
    b, n, nbits = 3, 5, 8
    rng = random.Random(21)
    ks = [[rng.randrange(1, R) for _ in range(n)] for _ in range(b)]
    ss = [[rng.randrange(1 << nbits) for _ in range(n)] for _ in range(b)]
    pts = [_points(row) for row in ks]
    pts = tuple(torch.stack([p[i] for p in pts]) for i in range(3))
    sc = torch.stack([C.pack_scalars(row, nbits, device="cpu") for row in ss])
    got = C.unpack_points(M.msm_pippenger_many(OPS, pts, sc, nbits, c=2), SPEC)
    assert got == [_oracle(kr, sr) for kr, sr in zip(ks, ss)]


@pytest.mark.parametrize("keys", ("all_equal", "all_zero", "all_max", "all_distinct", "runs"))
def test_window_sums_on_key_patterns(keys):
    """Two windows (W = 2) of 8 points, c = 3, digits given per window."""
    n, c = 8, 3
    rows = {"all_equal": [[5] * n, [7] * n], "all_zero": [[0] * n, [0] * n],
            "all_max": [[7] * n, [1] * n],
            "all_distinct": [list(range(n)), list(range(n - 1, -1, -1))],
            "runs": [[0, 0, 1, 3, 3, 3, 6, 7], [5, 5, 2, 2, 2, 2, 4, 4]]}[keys]
    rng = random.Random(len(keys))
    ks = [rng.randrange(1, R) for _ in range(n)]
    digits = torch.tensor(rows, dtype=torch.int64)
    got = C.unpack_points(M._msm_window(OPS, _points(ks), digits, c), SPEC)
    assert got == [_oracle(ks, row) for row in rows]
