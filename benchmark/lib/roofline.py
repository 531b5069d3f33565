"""The least time a piece of work can take on the card: the larger of its
bytes over the memory rate and its operations over the operation rate,
from the table of peaks (``benchmark/peaks.json``)."""

from __future__ import annotations

from benchmark.lib.harness import HERE, load_json


def peaks() -> dict:
    return load_json(HERE / "peaks.json")


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time and what sets
    it."""
    p = peaks()
    by_bytes = n_bytes / p["bytes_per_s"]
    by_ops = n_ops / p["flop_per_s"]
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def peak_text() -> str:
    p = peaks()
    return (f"{p['bytes_per_s'] / 1e12:g} TB/s and "
            f"{p['flop_per_s'] / 1e12:g} TFLOP/s")


def kernel_seconds(trace: dict, *names: str) -> tuple[float, int]:
    """(device seconds, launches) of the traced operations whose name holds
    any of ``names``."""
    s, n = 0.0, 0
    for op, (sec, calls) in trace["ops"].items():
        if any(k in op for k in names):
            s += sec
            n += calls
    return s, n
