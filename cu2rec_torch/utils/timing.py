"""Device timing: the barrier, marks in the device's work, and the host's
spans and counters.

A host clock around work on the card measures the enqueue unless the host
waits for the card first.  ``fetch_barrier`` waits for every kernel queued on
the tensors' CUDA devices; on the CPU there is nothing to wait for.
``mark``/``elapsed_ms`` time a stretch of queued work without a wait of its
own (CUDA events on the card).

``span(name)`` and ``count(name, n)`` mark the host's work at the program's
layer boundaries.  Nothing is recorded until ``trace_start()``; then each
span keeps (name, id, parent id, start, end) in memory, times from
``time.perf_counter`` (the clock a profile of the device is mapped onto),
its parent the innermost span open on the same thread, until
``trace_stop()`` returns them with the counters and turns recording off.
While recording is off ``span`` returns one shared object that does
nothing, and ``count`` returns at once.  Only a measurement (a benchmark, a
test) calls ``trace_start``.
"""

from __future__ import annotations

import itertools
import threading
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


class _Recording:
    """What one ``trace_start`` .. ``trace_stop`` keeps."""

    def __init__(self):
        self.spans: list[tuple] = []
        self.counters: dict[str, int] = {}
        self.lock = threading.Lock()


_recording: _Recording | None = None
_span_ids = itertools.count(1)


class _OpenSpans(threading.local):
    def __init__(self):
        self.ids: list[int] = []


_open = _OpenSpans()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        ids = _open.ids
        self.parent = ids[-1] if ids else None
        self.id = next(_span_ids)
        ids.append(self.id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        _open.ids.pop()
        rec = _recording
        if rec is not None:
            rec.spans.append((self.name, self.id, self.parent, self.t0, t1))
        return False


def span(name: str):
    """A context manager around one piece of the host's work: recorded
    when it closes, if recording is on then."""
    if _recording is None:
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    rec = _recording
    if rec is None:
        return
    with rec.lock:
        rec.counters[name] = rec.counters.get(name, 0) + n


def trace_start() -> None:
    """Start recording spans and counters, from none."""
    global _recording
    _recording = _Recording()


def trace_stop() -> dict:
    """Turn recording off and return what it kept: ``{"spans": [(name, id,
    parent_id, t0, t1), ...], "counters": {name: n}}``, spans in the order
    they closed, ``parent_id`` None for a span opened outside every other
    on its thread."""
    global _recording
    rec, _recording = _recording, None
    if rec is None:
        return {"spans": [], "counters": {}}
    return {"spans": rec.spans, "counters": rec.counters}
