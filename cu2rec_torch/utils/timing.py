"""Device timing: the barrier, and marks in the device's work.

A host clock around work on the card measures the enqueue unless the host
waits for the card first.  ``fetch_barrier`` waits for every kernel queued on
the tensors' CUDA devices; on the CPU there is nothing to wait for.
``mark``/``elapsed_ms`` time a stretch of queued work without a wait of its
own (CUDA events on the card).
"""

from __future__ import annotations

import time

import torch


def fetch_barrier(*tensors) -> None:
    """Wait until the work queued on each CUDA tensor's device is done."""
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def mark(device):
    """A point in the work queued on ``device``: a recorded CUDA event on
    the card, the host clock on the CPU (where work is done on return)."""
    if torch.device(device).type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def elapsed_ms(a, b) -> float:
    """Milliseconds between two ``mark``s; on the card, once the work up to
    ``b`` is done (a synchronize, or a read that waits for it)."""
    if isinstance(a, torch.cuda.Event):
        return a.elapsed_time(b)
    return (b - a) * 1e3
