"""The traced run's reduction: one call of each input set under
torch.profiler, cut into calls by their host intervals, and what the
per-layer metrics' readers (benchmark/metrics/<name>.py) read from it.

A call's device events are the kernels, copies and sets the device ran
between the call's host start and the next call's (each call ends in a
synchronize); its host launch calls are the runtime calls that issue
device work (kernel, copy, set and graph launches; a graph replay is one).
Busy time is the union of a call's device intervals; its span runs from
its host start to the later of its host end and its last device activity,
so the idle share (1 - busy / span) counts the host's time before the
first kernel.  The profiler slows the host, so that share is an upper
bound for an untraced call.  An idle gap is named by the profiler's own
host operation that covers most of it; where none does (the host plan's
numpy work records no operation), by the call's range.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")
CALL_LABEL = "bench.call"
PEAKS = Path(__file__).resolve().parent / "peaks.json"


@dataclass
class CallTrace:
    start: float  # host us
    end: float
    launches: int
    ops: list = field(default_factory=list)  # (name, start us, end us)

    def busy_us(self) -> float:
        busy, reach = 0.0, -math.inf
        for t0, t1 in sorted((a, b) for _, a, b in self.ops):
            busy += max(0.0, t1 - max(t0, reach))
            reach = max(reach, t1)
        return busy

    def span_us(self) -> float:
        last = max((b for _, _, b in self.ops), default=self.end)
        return max(self.end, last) - self.start


def peaks(card_name: str) -> dict | None:
    """The published peaks of the card (benchmark/peaks.json), or None."""
    for key, entry in json.loads(PEAKS.read_text()).items():
        if key in card_name:
            return entry
    return None


class Trace:
    """What a reader reads: the traced calls, their work by stage
    (benchmark/work.py) and the card's peaks for the working dtype."""

    def __init__(self, calls, work, dtype: str, card_peaks: dict | None):
        self.calls, self.work, self.dtype, self.card_peaks = calls, work, dtype, card_peaks

    @property
    def n(self) -> int:
        return len(self.calls)

    def has_device(self) -> bool:
        return any(c.ops for c in self.calls)

    def device_ms(self, symbols=(), exclude=()) -> float:
        """Device ms, over the traced calls, of the events whose name holds
        one of `symbols` (all events where none are given), less those that
        hold one of `exclude`."""
        tot = 0.0
        for c in self.calls:
            for name, t0, t1 in c.ops:
                if symbols and not any(s in name for s in symbols):
                    continue
                if any(s in name for s in exclude):
                    continue
                tot += t1 - t0
        return tot / 1e3

    def busy_ms(self) -> float:
        return sum(c.busy_us() for c in self.calls) / 1e3

    def span_ms(self) -> float:
        return sum(c.span_us() for c in self.calls) / 1e3

    def launches(self) -> int:
        return sum(c.launches for c in self.calls)

    def bound_ms(self, stages) -> float | None:
        """The traced calls' least time for the stages on the card's
        published peaks (work.bound_seconds per stage and call), or None
        for a card without an entry."""
        from .work import bound_seconds

        if self.card_peaks is None:
            return None
        flops = self.card_peaks["fma_flops"][self.dtype]
        bw = self.card_peaks["hbm_bytes_per_s"]
        return 1e3 * sum(bound_seconds(*w[s], flops, bw)
                         for w in self.work for s in stages if w[s][0] or w[s][1])


def _cpu(events):
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CPU]


def _device(events):
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA and e.name != CALL_LABEL]


def split_calls(events) -> list:
    """[CallTrace] of the profiled calls, in order."""
    cpu = _cpu(events)
    marks = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == CALL_LABEL)
    calls = []
    for i, (t0, t1) in enumerate(marks):
        nxt = marks[i + 1][0] if i + 1 < len(marks) else math.inf
        launches = sum(1 for e in cpu if e.name.startswith(LAUNCH_CALLS)
                       and t0 <= e.time_range.start < t1)
        ops = [(e.name, e.time_range.start, e.time_range.end) for e in _device(events)
               if t0 <= e.time_range.start < nxt]
        calls.append(CallTrace(t0, t1, launches, ops))
    return calls


def breakdown(events, calls, top: int = 10) -> dict:
    """{"device_ops": [[name, s]], "idle_gaps": [[name, s]]}: the device
    operations that took most time over the traced calls, and the longest
    idle gaps, each named by the host range within the call that covers
    most of it (the shortest of equals), else by the call's own range."""
    by_name = {}
    for c in calls:
        for name, t0, t1 in c.ops:
            by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    cpu = [(e.name, e.time_range.start, e.time_range.end) for e in _cpu(events)]
    gaps = []
    for c in calls:
        reach = c.start
        for _, t0, t1 in sorted(c.ops, key=lambda o: o[1]):
            if t0 > reach:
                gaps.append((reach, t0))
            reach = max(reach, t1)
        if c.end > reach:
            gaps.append((reach, c.end))
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        best = (0.0, 0.0, CALL_LABEL)
        for name, t0, t1 in cpu:
            over = min(g1, t1) - max(g0, t0)
            if name != CALL_LABEL and over > 0 and (over, -(t1 - t0)) > best[:2]:
                best = (over, -(t1 - t0), name)
        named.append([best[2], (g1 - g0) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def profile(steps, cuda: bool):
    """Run each of steps() once under torch.profiler, each inside the
    range CALL_LABEL and ending in a synchronize.  Returns the events."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with _profile(activities=acts) as prof:
        for step in steps:
            with torch.profiler.record_function(CALL_LABEL):
                step()
                sync()
    return prof.events()
