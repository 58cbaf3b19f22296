"""The mesh of the sharded layer over torch.distributed (the port of
zk_toolkit_tpu/parallel/mesh.py).

The JAX package has one controller that sees global arrays on a
jax.sharding.Mesh and lets XLA insert the collectives. torch.distributed
is SPMD over processes: one rank per process, each running the same code.
The port's sharded functions keep the JAX signatures, with a `Mesh` in
place of jax.sharding.Mesh, and work like this:

- every rank is handed the same global inputs (made from the same seed);
- each rank keeps its own slice of them: contiguous rows for the MSM and
  the NTT (`shard_leading`), every D-th element for the IPA;
- every rank returns the replicated result.

A `Mesh` is this process's place in a 1-D process group: its rank, the
world size, its device and the axis name. Its four methods `all_gather`,
`all_to_all`, `all_reduce` and `barrier` are the only process-group calls
of the sharded layer, and each counts its calls by kind in `mesh.counts`,
so the JAX package's "collective-free local phase" becomes a count that a
test can read.

Backends: NCCL for CUDA tensors (one card per rank), gloo for CPU tensors.
`make_mesh(1, "cuda")` makes a world of one in this process over NCCL.
Worlds of more ranks run in their own processes, started by `run_world`
or a reusable `World` pool, which rendezvous through a file in a temporary
directory, never a TCP port. There is no fallback: a world of more ranks
than cards on "cuda" raises, and so does "cuda" without a card; the caller
asks for the CPU explicitly.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

from zk_toolkit_tpu_torch import resolve_device

#: Seconds a collective waits for the other ranks before it raises.
COLLECTIVE_TIMEOUT_S = 300

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank of a 1-D mesh: `rank` of `world` processes, its `device`,
    the process group's `backend` and the axis name. `counts` holds the
    calls of each collective since it was last cleared."""

    rank: int
    world: int
    device: torch.device
    backend: str
    axis: str = "shard"
    store_dir: str | None = None
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[world, *t.shape]: row k is rank k's t."""
        self.counts["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return torch.stack(parts)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t [world, ...]: row k goes to rank k; row k of the result came
        from rank k. Equal splits only (gloo refuses others)."""
        if t.shape[0] != self.world:
            raise ValueError(f"all_to_all needs a leading axis of {self.world}, got {t.shape[0]}")
        self.counts["all_to_all"] += 1
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's t (a new tensor)."""
        self.counts["all_reduce"] += 1
        out = t.clone().contiguous()
        dist.all_reduce(out)
        return out

    def barrier(self) -> None:
        self.counts["barrier"] += 1
        dist.barrier()

    def close(self) -> None:
        """Ends the process group if this mesh made it (make_mesh's world of
        one: store_dir holds its rendezvous file); a World's ranks end
        theirs when the pool closes."""
        if self.store_dir is None:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.store_dir, ignore_errors=True)
        self.store_dir = None

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _backend(dev: torch.device, backend: str | None) -> str:
    want = _BACKENDS[dev.type]
    if backend not in (None, want):
        raise ValueError(f"device {dev.type!r} takes the {want} backend, not {backend!r}")
    return want


def _rank_device(dev: torch.device, rank: int, world: int) -> torch.device:
    """The CPU, or card `rank` on "cuda" (one card per rank)."""
    if dev.type != "cuda":
        return dev
    have = torch.cuda.device_count()
    if world > have:
        raise ValueError(f"requested {world} ranks on 'cuda', have {have} card(s); "
                         "one card serves one rank")
    return torch.device("cuda", rank)


def _init_group(backend: str, store_file: str, rank: int, world: int,
                dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def make_mesh(n_devices: int | None = None, device="cuda", backend: str | None = None,
              axis: str = "shard") -> Mesh:
    """The mesh of this process. Inside a rank of a World (the process
    group already made), its rank of that group, whose size must be
    n_devices when given. Otherwise a world of one (n_devices None or 1),
    made here: NCCL on card 0 for "cuda", gloo for "cpu"; close() ends it.
    A world of more ranks runs in a World."""
    dev = resolve_device(device)
    be = _backend(dev, backend)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices not in (None, world):
            raise ValueError(f"requested {n_devices} ranks inside a world of {world}")
        if dist.get_backend() != be:
            raise ValueError(f"the process group runs {dist.get_backend()}, not {be}")
        return Mesh(rank, world, _rank_device(dev, rank, world), be, axis)
    n = 1 if n_devices is None else n_devices
    if n != 1:
        raise ValueError(f"a world of {n} ranks runs in {n} processes: start it with "
                         "run_world or World")
    dev = _rank_device(dev, 0, 1)
    store = tempfile.mkdtemp(prefix="zkt_mesh_")
    try:
        _init_group(be, os.path.join(store, "rendezvous"), 0, 1, dev)
    except BaseException:
        shutil.rmtree(store, ignore_errors=True)
        raise
    return Mesh(0, 1, dev, be, axis, store_dir=store)


def _rows(mesh: Mesh, a: torch.Tensor) -> torch.Tensor:
    n = a.shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not split over {mesh.world} ranks")
    m = n // mesh.world
    return a[mesh.rank * m:(mesh.rank + 1) * m].to(mesh.device)


def shard_leading(mesh: Mesh, x):
    """This rank's contiguous block of rows of a tensor (or of each tensor
    of a tuple), on the mesh's device."""
    if isinstance(x, tuple):
        return tuple(_rows(mesh, a) for a in x)
    return _rows(mesh, x)


def replicate(mesh: Mesh, x):
    """The whole tensor (or tuple of tensors) on the mesh's device."""
    if isinstance(x, tuple):
        return tuple(a.to(mesh.device) for a in x)
    return x.to(mesh.device)


# -- worlds of ranks in processes ---------------------------------------------------

def _failure(exc: BaseException) -> tuple:
    """(the exception, or a RuntimeError naming it when it cannot be
    pickled; its traceback text). Called inside the except block."""
    tb = traceback.format_exc()
    try:
        pickle.dumps(exc)
    except (pickle.PicklingError, TypeError, AttributeError):
        exc = RuntimeError(f"{type(exc).__name__}: {exc}")
    return exc, tb


def _rank_main(rank: int, world: int, device: str, store_file: str, tasks, results) -> None:
    """A rank's process: joins the group, then runs fn(mesh, *args) for each
    task until it reads None, sending back (rank, ok, result or failure)."""
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = _rank_device(torch.device(device), rank, world)
        be = _backend(dev, None)
        _init_group(be, store_file, rank, world, dev)
        mesh = Mesh(rank, world, dev, be)
    except Exception as e:  # the group never formed: answer every task with why
        failure = _failure(e)
        while tasks.get() is not None:
            results.put((rank, False, failure))
        return
    try:
        while (task := tasks.get()) is not None:
            fn, args = task
            mesh.counts.clear()
            try:
                results.put((rank, True, fn(mesh, *args)))
            except Exception as e:  # reported to the caller, who re-raises it
                results.put((rank, False, _failure(e)))
    finally:
        dist.destroy_process_group()


class RankError(RuntimeError):
    """Ranks that died or did not answer; and, as the __cause__ of a
    rank's exception re-raised in the caller, that rank's traceback."""


class World:
    """A pool of `world` rank processes (spawn context) joined in one
    process group: gloo on "cpu", NCCL on "cuda" with card k for rank k.
    `run(fn, *args)` runs fn(mesh, *args) on every rank and returns rank 0's
    result, or re-raises the exception of the lowest rank that raised; fn
    and args go by pickle, so fn is a module-level function.
    The pool is reused across runs, so a caller pays the ranks' start-up
    (a few seconds) once; close() (or leaving the `with` block) ends it.
    A run whose ranks die, or do not answer within twice the collective
    timeout, closes the pool and raises RankError."""

    def __init__(self, world: int, device="cpu"):
        if world < 1:
            raise ValueError(f"a world has at least one rank, not {world}")
        dev = resolve_device(device)
        _rank_device(dev, world - 1, world)
        self.world, self.device = world, dev.type
        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="zkt_world_")
        store = os.path.join(self._dir, "rendezvous")
        self._tasks = [ctx.SimpleQueue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world, self.device, store, self._tasks[r],
                                         self._results))
                       for r in range(world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args):
        if self._procs is None:
            raise RuntimeError("this World is closed")
        for q in self._tasks:
            q.put((fn, args))
        replies = {}
        waited = 0.0
        while len(replies) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
                replies[rank] = (ok, value)
                continue
            except queue.Empty:
                waited += 1.0
            dead = [r for r, p in enumerate(self._procs) if not p.is_alive() and r not in replies]
            if dead or waited > 2 * COLLECTIVE_TIMEOUT_S:
                codes = {r: self._procs[r].exitcode for r in dead}
                self.close()
                raise RankError(f"ranks {sorted(set(range(self.world)) - set(replies))} did "
                                f"not answer (exit codes {codes}, waited {waited:.0f} s)")
        for rank in range(self.world):
            ok, value = replies[rank]
            if not ok:
                exc, tb = value
                raise exc from RankError(f"rank {rank} of {self.world} raised:\n{tb}")
        return replies[0][1]

    def close(self) -> None:
        if self._procs is None:
            return
        for p, q in zip(self._procs, self._tasks):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_world(fn, world: int, device, *args):
    """fn(mesh, *args) on every rank of a fresh World of `world` ranks on
    `device`; rank 0's result. A rank's exception is re-raised here, its
    traceback in the RankError it is chained from."""
    with World(world, device) as w:
        return w.run(fn, *args)
