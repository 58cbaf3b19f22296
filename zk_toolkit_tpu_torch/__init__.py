"""zk_toolkit_tpu_torch: the PyTorch/CUDA port of zk_toolkit_tpu.

The port keeps the JAX package's sub-paths and function names and its
tensor layout (16-bit limbs in int32 lanes, Montgomery form, Jacobian
(x, y, z) with infinity <=> z == 0), so each function compares limb for limb
with its counterpart. Every Pallas kernel of the JAX package is a CUDA C++
kernel here (csrc/, built by _build.py). Entry points default to
device="cuda" and raise when there is no card; pass device="cpu" to run the
plain PyTorch versions.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and there is
    no card (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
