"""The program's own spans and counters, for a traced run.

The port records spans (name, id, parent id, start, end) and counters at
its layer boundaries once ``cu2rec_torch.utils.timing.trace_start()`` is
called, and nothing before.  A traced run starts it when its ``Context`` is
made (``ProgramTrace.start``), keeps what set-up recorded and starts afresh
where the window opens (``open_window``), and stops it where the window
closes (``close_window``).  The spans' times are ``time.perf_counter``
seconds, the clock of the benchmark's own spans, onto which
``harness.stop_profile`` maps the device's events; so ``host_spans`` can
join the benchmark's spans in labelling each idle gap of the device.

A checkout whose program has no recorder records nothing:
``ProgramTrace.start`` returns None.

``innermost`` labels each point in time by the innermost span that holds
it, however many spans opened and closed before it inside that span.
"""

from __future__ import annotations

HOST = "host"


def recorder():
    """The program's ``utils.timing`` module where it has the recorder,
    else None."""
    try:
        from cu2rec_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, "trace_start") else None


class ProgramTrace:
    """The program's recording over one run: ``setup`` and ``window``, each
    ``{"spans": [(name, id, parent_id, t0, t1)], "counters": {...}}`` as
    ``trace_stop`` returns it, once taken."""

    def __init__(self, timing):
        self.timing = timing
        self.setup = self.window = None

    @classmethod
    def start(cls):
        timing = recorder()
        if timing is None:
            return None
        timing.trace_start()
        return cls(timing)

    def open_window(self) -> None:
        self.setup = self.timing.trace_stop()
        self.timing.trace_start()

    def close_window(self) -> None:
        self.window = self.timing.trace_stop()

    def host_spans(self, t0: float, t_end: float) -> list:
        """(name, start, end) of the window's spans that overlap [t0,
        t_end], the form of the benchmark's own spans."""
        return [(name, a, b) for name, _i, _p, a, b in self.window["spans"]
                if b > t0 and a < t_end]

    def record(self, t0: float, t_end: float) -> dict:
        """The record's keys: ``program_spans`` ({name: [seconds, count]}
        over the window, each span cut to it), ``program_counters`` (counted
        in the window) and ``program_setup_s`` (the parentless spans that
        ended before the window opened)."""
        spans: dict = {}
        for name, a, b in self.host_spans(t0, t_end):
            s = spans.setdefault(name, [0.0, 0])
            s[0] += min(b, t_end) - max(a, t0)
            s[1] += 1
        setup = sum(b - a for _n, _i, parent, a, b in self.setup["spans"]
                    if parent is None and b <= t0)
        return {"program_spans": spans,
                "program_counters": dict(self.window["counters"]),
                "program_setup_s": setup}


def innermost(spans, points) -> list[str]:
    """For each time in ``points``, the label of the innermost of
    ``spans`` ((label, start, end)) that holds it, the latest to start
    among those (of two that start together, the shorter), or ``HOST``
    outside every span.  One sweep over the spans in order of their start
    with a stack of those open, whatever their depth."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out = [HOST] * len(points)
    stack: list = []
    k = 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        while k < len(spans) and spans[k][1] <= t:
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][0]
    return out
