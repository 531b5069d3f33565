"""``chip_smoke.py``'s profiling on the CPU, with stand-in profiler sessions:
a session that records no device event is run again, at most
``PROFILE_TRIES`` times, both for the step loop and for a serving wave's
replay, and the smoke fails after that many empty sessions."""

import importlib.util
import json
import pathlib
import threading
from types import SimpleNamespace

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class _Session:
    """A profiler session that records the given events, parsed
    (``events()``) and raw (``profiler.kineto_results.events()``)."""

    def __init__(self, events):
        self._events = events
        raw = [SimpleNamespace(device_type=lambda e=e: e.device_type)
               for e in events]
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: raw))

    def start(self):
        pass

    def stop(self):
        pass

    def events(self):
        return self._events


def _event(device, name="kernel", start=0, end=5):
    return SimpleNamespace(device_type=device, name=name,
                           time_range=SimpleNamespace(start=start, end=end))


CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def test_profiled_runs_again_until_a_session_records_device_time():
    smoke = _smoke()
    sessions = iter([_Session([]), _Session([_event(CPU)]),
                     _Session([_event(CPU), _event(CUDA)])])
    runs = []
    prof, host_s = smoke._profiled(torch, lambda: runs.append(1),
                                   lambda: next(sessions))
    assert len(runs) == 3 and host_s >= 0
    assert smoke._device_breakdown(torch, prof) == (5e-6,
                                                    [("kernel", 0.005, 1)])


def test_profiled_fails_after_as_many_empty_sessions_as_it_tries():
    smoke = _smoke()
    runs = []
    with pytest.raises(smoke.SmokeFailure, match="no device time"):
        smoke._profiled(torch, lambda: runs.append(1),
                        lambda: _Session([_event(CPU)]))
    assert len(runs) == smoke.PROFILE_TRIES


def test_wave_input_replays_a_wave_while_its_profile_is_empty():
    """The serve phase's replay of a wave goes out again, under new ids,
    until its session records device time; the attempt kept is noted."""
    smoke = _smoke()
    waves = [[{"id": "a", "op": "recommend"}], [{"id": "s", "op": "stats"}]]
    out = SimpleNamespace(cond=threading.Condition(), t_done={
        i: 0.0 for i in ("a", "a~prof0", "a~prof1", "s")})
    sessions = iter([_Session([]), _Session([_event(CUDA)])])
    inp = smoke._WaveInput(waves, out, lambda: 0, lambda: next(sessions),
                           lambda p: smoke._has_device_time(torch, p))
    sent = [json.loads(line)["id"] for line in inp]
    assert sent == ["a", "a~prof0", "a~prof1", "s"]
    assert [attempt for _, _, attempt in inp.profiles] == [1]
    assert inp.counts == [(0, 0), (0, 0)]


def test_has_device_time_reads_a_real_session():
    """On a real session of the CPU profiler, which records no device
    event, the check reads the raw trace and finds none."""
    from torch.profiler import ProfilerActivity

    smoke = _smoke()
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU])
    prof.start()
    torch.ones(8).sum()
    prof.stop()
    assert not smoke._has_device_time(torch, prof)
    assert any(e.device_type == CPU for e in prof.events())
