"""The flagship compute step of the port (the counterpart of the
repository's __graft_entry__.entry): a batch of BLS12-381 optimal-ate Miller
loops, the hot loop under the Groth16, Pinocchio and BLS verifiers.

    from zk_toolkit_tpu_torch.entry import entry
    fn, args = entry()          # device="cuda"; pass device="cpu" to run
    f = fn(*args)               # the plain versions
"""

from __future__ import annotations


def entry(device="cuda"):
    """(fn, args): fn(p_aff, q_aff) runs BlsPairingOps.miller_loop on the
    affine batches G1 * {1, 7} and G2 * {1, 11}, packed on `device`, and
    returns the Fq12 tensor [2, 2, 3, 2, K]."""
    from zk_toolkit_tpu_torch.curves.bls12_381 import g1, g2
    from zk_toolkit_tpu_torch.ops import pairing_ops as P

    ops = P.bls_pairing_ops()
    spec = ops.f.spec
    pa = P.pack_g1_affine([g1.g(), g1.g() * 7], spec, device)
    qa = P.pack_g2_affine([g2.g(), g2.g() * 11], spec, device)

    def miller_batch(p_aff, q_aff):
        return ops.miller_loop(p_aff, q_aff)

    return miller_batch, (pa, qa)
