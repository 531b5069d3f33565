"""What the probes (and ``chip_smoke.py``) share: CUDA-event timing and
the JSON record stream."""

from __future__ import annotations

import json

import torch


def time_ms(fn, inputs, reps: int, warm: int = 2) -> float:
    """Mean ms per call of ``fn(*inputs[r % len(inputs)])`` over ``reps``
    calls, timed with CUDA events after ``warm`` calls.  Cycle through
    sets whose total exceeds the 50 MB L2 where a real caller would find
    the cache cold."""
    for r in range(warm):
        fn(*inputs[r % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fn(*inputs[r % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Records:
    """Prints each record as a JSON line (with the card's name) and, given
    a path, appends them there at ``close``."""

    def __init__(self, out: str | None):
        self.out = out
        self.kind = torch.cuda.get_device_name(0)
        self.records: list[dict] = []

    def emit(self, **kw) -> dict:
        kw["device"] = self.kind
        self.records.append(kw)
        print(json.dumps(kw), flush=True)
        return kw

    def close(self) -> None:
        if self.out:
            with open(self.out, "a") as fh:
                for r in self.records:
                    fh.write(json.dumps(r) + "\n")
