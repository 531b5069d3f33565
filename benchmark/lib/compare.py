"""The comparisons that decide ``correct``: numbers computed from the
program's outputs and the plain reference's, each held against its limit.

Training cells compare by leaf (one table of the model): the gap between
the program's norm of a change and the reference's, measured against the
reference's norm of that leaf or of the median leaf, whichever is larger;
and the widest gap of a single entry of the change, against the largest
entry of the reference's change in that leaf.
"""

from __future__ import annotations

import statistics

import torch


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def norm_gap(prog: dict, ref: dict) -> float:
    """Worst leaf's |‖prog‖ − ‖ref‖| / max(‖ref leaf‖, median ‖ref‖) of
    the changes by leaf (dicts of tensors with the same keys)."""
    ref_n = {k: norm(v) for k, v in ref.items()}
    med = statistics.median(ref_n.values())
    return max(abs(norm(prog[k]) - ref_n[k]) / max(ref_n[k], med, 1e-300)
               for k in ref)


def max_gap(prog: dict, ref: dict) -> float:
    """Worst leaf's max |prog − ref| / max |ref| over its entries."""
    out = 0.0
    for k, r in ref.items():
        r = r.to(torch.float64)
        d = (prog[k].to(torch.float64).to(r.device) - r).abs().max()
        out = max(out, float(d) / max(float(r.abs().max()), 1e-300))
    return out


def exact_gap(prog: dict, ref: dict) -> float:
    """Largest |prog − ref| over every entry of every leaf."""
    return max(float((prog[k].to(torch.float64).to(r.device)
                      - r.to(torch.float64)).abs().max())
               for k, r in ref.items())


def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit,
            "ok": bool(value <= limit)}
