"""Device timing barrier.

A host clock around work on the card measures the enqueue unless the host
waits for the card first.  ``fetch_barrier`` waits for every kernel queued on
the tensors' CUDA devices; on the CPU there is nothing to wait for.
"""

from __future__ import annotations

import torch


def fetch_barrier(*tensors) -> None:
    """Wait until the work queued on each CUDA tensor's device is done."""
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
