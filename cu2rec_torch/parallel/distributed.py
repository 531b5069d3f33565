"""Ranks and collectives of the multi-GPU engines.

The TPU package runs one controller over a device mesh (its
``parallel/distributed.py`` starts that runtime's multi-host service).
The PyTorch idiom is one process a device: ``initialize`` joins this
process to a ``torch.distributed`` world, the backend an explicit argument
(``nccl`` for one rank a card, ``gloo`` for ranks on the CPU or sharing one
card), and ``launch`` starts such a world on this host and returns what
each rank's function returned.

The engines use one collective, ``all_reduce``, with SUM and with MIN
(``Axis.sum_``, ``Axis.min_``): the gloo backend takes CUDA tensors for
``all_reduce`` and ``broadcast`` only, so the same code runs under gloo on
the CPU, under gloo with ranks sharing one card and under NCCL.  An
all_gather is ``Axis.assemble_``: an all_reduce(SUM) of a zero-filled
buffer into which each rank has written only the elements it owns.  With
one contributor an element that sum is the contributor's bits, so the
buffer is reduced as int32 words: exact for float32 and bf16 alike.

Usage, one process a rank::

    from cu2rec_torch.parallel.distributed import launch
    results = launch(fn, world=2, backend="gloo", device="cpu", args=(x,))

``fn(*args)`` runs in every rank after ``initialize``; it builds its grid
with ``parallel.sharded.make_mesh``, and what it returns comes back from
every rank.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# Seconds ``launch`` waits for its ranks before it stops them, when the
# caller gives no limit (None: as long as they run).
LAUNCH_TIMEOUT: float | None = None

_device: torch.device | None = None


def initialize(backend: str, init_method: str, world_size: int, rank: int,
               device=None) -> None:
    """Join this process to a world of ``world_size`` ranks as ``rank``,
    rendezvousing at ``init_method`` (``tcp://host:port`` or
    ``file:///path``).  ``device`` is the rank's device, which the engines
    take by default (``local_device``)."""
    global _device
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if device is not None:
        _device = torch.device(device)
        if _device.type == "cuda":
            if _device.index is None:
                _device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(_device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def is_multiprocess() -> bool:
    return process_info()[1] > 1


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) outside a ``torch.distributed`` world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device() -> torch.device | None:
    """The device ``initialize`` gave this rank, or None."""
    return _device


@dataclass(frozen=True)
class Axis:
    """Ranks that reduce together: their process group (None: the whole
    world) and how many they are.  Every collective is a no-op on an axis
    of one rank."""

    group: object
    size: int

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size > 1:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the axis, in place (the TPU package's
        ``psum``)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def min_(self, t: torch.Tensor) -> torch.Tensor:
        """The least ``t`` over the axis, in place (``pmin``)."""
        return self._reduce(t, dist.ReduceOp.MIN)

    def assemble_(self, t: torch.Tensor) -> torch.Tensor:
        """Each element from the one rank that wrote it, the others having
        left it zero (an ``all_gather``), in place and bit for bit: the
        buffer's bytes are summed as int32 words."""
        if self.size > 1:
            if not t.is_contiguous() or t.numel() * t.element_size() % 4:
                raise ValueError("assemble_ takes a contiguous buffer of "
                                 "whole 4-byte words")
            dist.all_reduce(t.view(torch.int32), op=dist.ReduceOp.SUM,
                            group=self.group)
        return t


WORLD_OF_ONE = Axis(None, 1)


def world_axis() -> Axis:
    return Axis(None, process_info()[1])


def barrier(device=None) -> None:
    """Every rank waits for the others (an all_reduce of one word on the
    rank's device)."""
    if is_multiprocess():
        dev = torch.device(device or local_device() or "cpu")
        world_axis().sum_(torch.zeros(1, dtype=torch.int32, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def rank_device(rank: int, backend: str, device_type: str) -> torch.device:
    """A rank's device: the CPU, ``cuda:(rank % device_count)`` under NCCL,
    or ``cuda:0`` under gloo (ranks sharing one card)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cuda", 0)


def _rank_main(fn, rank: int, world: int, backend: str, device_type: str,
               init_method: str, out_dir: str, args, kwargs) -> None:
    """A spawned rank: join the world, run ``fn(*args)``, write its result
    (or its traceback) where ``launch`` reads it."""
    try:
        dev = rank_device(rank, backend, device_type)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        initialize(backend, init_method, world, rank, dev)
        result = fn(*args, **kwargs)
        tmp = os.path.join(out_dir, f"result.{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(out_dir, f"result.{rank}"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def launch(fn, world: int, backend: str = "gloo", device="cpu",
           args: tuple = (), kwargs: dict | None = None,
           timeout: float | None = None) -> list:
    """Run ``fn(*args, **kwargs)`` in ``world`` new processes (the ``spawn`` start
    method) joined as one ``torch.distributed`` world over a file
    rendezvous; returns each rank's result, rank by rank (each must
    pickle).

    ``device`` "cpu" puts every rank on the CPU; "cuda" gives rank r the
    card ``cuda:(r % device_count)`` under NCCL, which then needs ``world``
    cards, and ``cuda:0`` to every rank under gloo.  On the card the
    kernels are built here first, so that the ranks never build into the
    shared build directory at once.  If a rank fails, or the ranks
    outlast ``timeout`` seconds (default ``LAUNCH_TIMEOUT``), the others
    are stopped and ``launch`` raises with the failed rank's
    traceback."""
    import multiprocessing as mp

    device_type = torch.device(device).type
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and n_cards < world:
            raise RuntimeError(
                f"{world} ranks under NCCL need {world} CUDA devices (one "
                f"a rank), and this host has {n_cards}")
        from cu2rec_torch.csrc.build import KERNELS, build
        build(KERNELS)
    elif backend == "nccl":
        raise ValueError("NCCL takes CUDA devices; use gloo on the CPU")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="cu2rec_ranks_") as out_dir:
        init = "file://" + os.path.join(out_dir, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, world, backend, device_type, init, out_dir, args,
            kwargs or {}))
            for rank in range(world)]
        for p in procs:
            p.start()
        timeout = LAUNCH_TIMEOUT if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    _stop(procs)
                    raise RuntimeError(_failure(out_dir, procs, failed))
                if deadline is not None and time.monotonic() > deadline:
                    _stop(procs)
                    raise TimeoutError(f"{world} ranks did not finish in "
                                       f"{timeout:.0f} s")
                time.sleep(0.02)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(_failure(out_dir, procs, failed))
            results = []
            for rank in range(world):
                with open(os.path.join(out_dir, f"result.{rank}"),
                          "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            _stop(procs)


def _failure(out_dir: str, procs, failed) -> str:
    msgs = []
    for r in failed:
        path = os.path.join(out_dir, f"error.{r}")
        text = open(path).read() if os.path.exists(path) else \
            f"exit code {procs[r].exitcode}, no traceback written"
        msgs.append(f"rank {r} failed:\n{text}")
    return "\n".join(msgs)
