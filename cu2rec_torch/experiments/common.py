"""What the probes (and ``chip_smoke.py``) share: CUDA-event timing, the
JSON record stream, and the A B B A turns of two checkouts on one card."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


# A spin of the card long enough for the host to enqueue a timed run behind
# it: about 20 ms at the H100's boost clock.
HOLD_CYCLES = 40_000_000


def time_ms(fn, inputs, reps: int, warm: int = 2, hold: bool = False) -> float:
    """Mean ms per call of ``fn(*inputs[r % len(inputs)])`` over ``reps``
    calls, timed with CUDA events after ``warm`` calls.  Cycle through
    sets whose total exceeds the 50 MB L2 where a real caller would find
    the cache cold.

    With ``hold``, a spin of the card (``torch.cuda._sleep``) holds the
    stream while the host enqueues the calls, so that the events time the
    card's work alone, not the host's launch overhead; ``fn`` must then not
    synchronize.  It raises if the spin ended before the host had enqueued
    every call."""
    for r in range(warm):
        fn(*inputs[r % len(inputs)])
    torch.cuda.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        spin.record()
        torch.cuda._sleep(HOLD_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for r in range(reps):
        fn(*inputs[r % len(inputs)])
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if hold and spin.elapsed_time(start) < enqueue_ms:
        raise RuntimeError(f"the spin ({spin.elapsed_time(start):.2f} ms) "
                           f"ended before the host had enqueued the run "
                           f"({enqueue_ms:.2f} ms)")
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


def checkout_run(root: Path, code: str, *argv: str,
                 timeout: float = 900) -> dict:
    """``python -c code argv...`` from the root of a checkout, so that it
    imports that checkout's ``cu2rec_torch`` and builds its kernels; the
    JSON object its last line of standard output holds."""
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=root,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise SystemExit(f"the run in {root} failed (rc {proc.returncode}):"
                         f"\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def abba(a: Path, b: Path, run) -> list[dict]:
    """``run(root)`` in checkout a, then b, b and a, each record printed as
    it comes and labelled with its checkout ("a" or "b")."""
    runs = []
    for label, root in (("a", a), ("b", b), ("b", b), ("a", a)):
        rec = {"checkout": label, "root": str(root.resolve()),
               **run(root.resolve())}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    return runs


def _median(values: list):
    """The median of numbers; of dicts or lists of them, entry by entry."""
    if isinstance(values[0], dict):
        return {k: _median([v[k] for v in values]) for k in values[0]}
    if isinstance(values[0], list):
        return [_median(list(col)) for col in zip(*values)]
    return statistics.median(values)


def medians(runs: list[dict], keys) -> dict:
    """Each checkout's median of each record key in ``keys`` that its runs
    hold, over its runs (``abba``'s records)."""
    out = {}
    for label in ("a", "b"):
        mine = [r for r in runs if r["checkout"] == label]
        out[label] = {key: _median([r[key] for r in mine])
                      for key in keys if key in mine[0]}
    return out
