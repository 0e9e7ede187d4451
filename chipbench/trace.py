"""Host spans around the calls into the program's layers, and the device's
timeline from ``torch.profiler``, on one clock (the host's
``time.perf_counter``)."""

from __future__ import annotations

import time

from chipbench import stats


class Spans:
    """``(name, start, end)`` spans of wrapped calls, in perf_counter seconds.

    ``wrap(owner, attr, name)`` replaces ``owner.attr`` (an instance's
    method or a module's function) by a recording wrapper, and returns the
    call that puts the original back.  Recording is off until ``on`` is
    set.
    """

    def __init__(self) -> None:
        self.items: list[tuple[str, float, float]] = []
        self.on = False

    def wrap(self, owner, attr: str, name: str):
        fn = getattr(owner, attr)
        items = self.items

        def wrapper(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                items.append((name, t0, time.perf_counter()))

        setattr(owner, attr, wrapper)
        return lambda: setattr(owner, attr, fn)


class DeviceTrace:
    """``torch.profiler`` over the CUDA activity only (no host-side op
    records, so the host's pace stays as it is untraced).  ``events()``
    gives every kernel, copy and memset as ``(name, start, end)`` on the
    perf_counter clock: the profiler stamps device events in Unix-epoch
    nanoseconds, and the offset between the two clocks is read when the
    trace starts."""

    def __init__(self) -> None:
        self._prof = None
        self._offset_ns = 0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(*exc)

    def events(self) -> list[tuple[str, float, float]]:
        from torch.autograd import DeviceType

        out = []
        off = self._offset_ns
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = (e.start_ns() - off) * 1e-9
            out.append((e.name(), s, s + e.duration_ns() * 1e-9))
        return out


def breakdown(device, spans, lo: float, hi: float, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time inside ``[lo, hi]`` by the host span open at the time
    (``harness`` where none was), each summed by name, largest first.
    Host spans follow one another; where two overlap, the earlier keeps the
    overlap."""
    ops: dict[str, float] = {}
    for name, s, e in device:
        ops[name] = ops.get(name, 0.0) + (e - s)
    idle: dict[str, float] = {}
    timeline, t = [], -float("inf")
    for name, s, e in sorted(spans, key=lambda x: x[1]):
        s = max(s, t)
        if e > s:
            timeline.append((name, s, e))
            t = e
    i = 0
    for gs, ge in stats.idle_gaps([(s, e) for _, s, e in device], lo, hi):
        while i < len(timeline) and timeline[i][2] <= gs:
            i += 1
        covered, j = 0.0, i
        while j < len(timeline) and timeline[j][1] < ge:
            name, s, e = timeline[j]
            part = min(e, ge) - max(s, gs)
            idle[name] = idle.get(name, 0.0) + part
            covered += part
            j += 1
        if ge - gs - covered > 0:
            idle["harness"] = idle.get("harness", 0.0) + (ge - gs - covered)

    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": largest(ops), "idle_gaps": largest(idle)}
