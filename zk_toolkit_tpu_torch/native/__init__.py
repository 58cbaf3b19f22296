"""ctypes bindings for the port's C++ host engine (native/zkt_host.cpp in
this package, the port's copy of the JAX package's): batched Montgomery
arithmetic mod <= 256-bit primes for the CRS's Lagrange values and scalar
packing. Built with g++ at first use; `engine(p)` is None only when g++ is
not on the PATH, and the callers then take the pure-Python branch."""

from zk_toolkit_tpu_torch.native.host import FrEngine, available, engine

__all__ = ["FrEngine", "available", "engine"]
