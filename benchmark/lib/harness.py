"""What every run of a cell shares: finding a cell's files by name, the
measured window, the trace, the spans and counters a driver records, the
look for forbidden modules, and the result line.

Nothing here knows a configuration, a traffic mix or a metric: those are
files found by the names in ``BENCHMARK.json`` and in the cell's workload
file (``benchmark/README.md``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent                                   # the checkout
# Top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "cu2rec_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py``, loaded by its path (a
    name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"_bench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is in ``FORBIDDEN``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without a
    trace, the per-layer ones with it; each where its ``workloads`` lists
    the cell or where it has no such list."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


class Forbidden(RuntimeError):
    """A module of JAX or of the JAX package is loaded."""


def assert_clean(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise Forbidden(f"modules of JAX or of the JAX package are loaded "
                        f"{when}: " + ", ".join(found))


class Spans:
    """Host spans recorded by the benchmark's own code around its calls
    into the program: (label, start, end) on the ``perf_counter`` clock,
    kept in memory."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.on = False

    def span(self, label: str):
        return _Span(self, label)

    def totals(self) -> dict:
        """{label: [seconds, count]}."""
        out: dict = {}
        for label, a, b in self.items:
            s = out.setdefault(label, [0.0, 0])
            s[0] += b - a
            s[1] += 1
        return out


class _Span:
    def __init__(self, spans: Spans, label: str):
        self.spans, self.label = spans, label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.spans.on:
            self.spans.items.append((self.label, self.t0,
                                     time.perf_counter()))
        return False


class Context:
    """One run: its arguments, its files, the window and the trace.

    A driver calls ``open_window()`` when set-up is done, checks
    ``expired()`` at the points where the window may close, and calls
    ``close_window()`` once the work up to that point is finished on the
    card.  Then it reads ``memory_peak()``, frees the program's state and
    runs its comparison."""

    def __init__(self, t_start: float, cell: str, workload: dict,
                 config: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda"):
        self.t_start = t_start
        self.cell, self.workload, self.config = cell, workload, config
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.spans = Spans()
        self.counters: dict = {}
        self.t0 = self.t_end = None
        self.setup_s = None
        self._prof = None
        self.trace_record = None

    def log(self, msg: str) -> None:
        """A line on standard error with the seconds since the start."""
        print(f"benchmark: [{time.perf_counter() - self.t_start:8.3f} s] "
              f"{msg}", file=sys.stderr, flush=True)

    # -- the window --------------------------------------------------------
    def open_window(self) -> None:
        """Set-up is done: the card is drained, set-up's garbage collected
        and what it left frozen out of later collections (so that the
        window's collections do not walk the harness's data), the trace
        started, and the clock read."""
        import gc

        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        assert_clean("after set-up")
        gc.collect()
        gc.freeze()
        if self.trace:
            self._prof = start_profile(self.device)
        self.setup_s = time.perf_counter() - self.t_start
        self.spans.on = True
        self.t0 = time.perf_counter()

    def expired(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    def close_window(self) -> None:
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
        self.t_end = time.perf_counter()
        self.spans.on = False
        if self._prof is not None:
            self.trace_record = stop_profile(self._prof, self.t0, self.t_end,
                                             self.spans.items)
            self._prof = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def memory_peak(self) -> int:
        import torch

        if self.device != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(d)
                   for d in range(torch.cuda.device_count()))


# -- the trace ----------------------------------------------------------------

def start_profile(device: str):
    """A started ``torch.profiler`` profile of the device's activity alone,
    with its clock offset: (profile, perf_counter_ns - time_ns at its
    start)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device == "cuda" else \
        [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.start()
    return prof, time.perf_counter_ns() - time.time_ns()


def _union(spans) -> tuple[float, list]:
    """(total length, merged intervals) of (start, end) pairs."""
    merged: list = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def stop_profile(started, t0: float, t_end: float, spans) -> dict:
    """The device's record over the window [t0, t_end] (``perf_counter``
    seconds): busy seconds (the union of device operations), seconds by
    operation name, and the idle gaps summed by the host span they fall
    in.  Device events carry the profiler's wall clock in ns; ``offset``
    maps it to ``perf_counter``."""
    import torch

    prof, offset = started
    prof.stop()
    lo, hi = t0 * 1e9, t_end * 1e9
    intervals, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        a = e.start_ns() + offset
        b = a + e.duration_ns()
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        intervals.append((a, b))
        s = by_name.setdefault(e.name(), [0.0, 0])
        s[0] += (b - a) / 1e9
        s[1] += 1
    busy_ns, merged = _union(intervals)
    gaps: dict = {}
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    host = sorted((a * 1e9, b * 1e9, label) for label, a, b in spans)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = _host_label(host, (a + b) / 2)
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return {"busy_s": busy_ns / 1e9, "window_s": t_end - t0,
            "ops": by_name, "idle": gaps, "n_events": len(intervals)}


def _host_label(host, t: float) -> str:
    """The innermost host span that holds time ``t`` (the latest to start
    among those that hold it), or ``host`` outside every span."""
    import bisect

    i = bisect.bisect_right(host, (t, float("inf"), ""))
    for a, b, label in reversed(host[max(0, i - 64):i]):
        if a <= t <= b:
            return label
    return "host"


def breakdown(trace: dict) -> dict:
    def top(d, key):
        return [[k, key(v)] for k, v in sorted(
            d.items(), key=lambda kv: -key(kv[1]))[:10]]

    return {"device_ops": top(trace["ops"], lambda v: v[0]),
            "idle_gaps": top(trace["idle"], lambda v: v)}


# -- the device ---------------------------------------------------------------

def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def power_line() -> str:
    """The card's name and power limit from ``nvidia-smi``, or why not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi: {out.stderr.strip()[:200]}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
