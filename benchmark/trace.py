"""The traced stretches of a `--trace 1` run: torch.profiler and its reading.

A traced run profiles two stretches of its measured window, one after the
other (`Schedule`), each between two synchronisations of the card:
- the steady stretch, CUDA activity alone (kernels, copies, memsets and
  the runtime calls that launch them): `window_s` is its host wall time,
  `busy_s` the union of device activity in it, `items` the frames or steps
  it covered, `device_ops` the device seconds by kernel group
  (`groups.GROUPS`). Tracing lengthens the host's side of each item (by
  a third in a launch-bound step), not the device's, and a profiler
  session leaves the process's later items slower too, so the idle share
  is taken against the pace of the window's items before the first
  stretch, when no profiler has run in the process: `item_s`, their
  seconds per item;
- the attribution stretch, CPU and CUDA activity with the harness's spans
  (`span`) around calls into the program: `idle_gaps`, the stretch's idle
  device time by the host operation running at each gap's middle (the
  innermost traced operation of any thread, or the harness's span). Host
  tracing slows the host, so these gaps are longer than the steady
  stretch's.
The profiler's first start takes seconds; it falls before the steady
stretch's clock starts.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from benchmark.groups import group

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
STRETCH = "bench.stretch"


def span(name: str):
    """A harness span: a `record_function` range named `name`."""
    return torch.profiler.record_function(name)


def maybe_span(name: str, on: bool):
    """`span(name)` when `on`, else nothing."""
    return span(name) if on else contextlib.nullcontext()


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Stretch:
    """Profile from `start()` to `stop()` (`host`: CPU activity too);
    `read()` after `stop()`."""

    def __init__(self, host: bool) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        if host or not acts:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.host = host
        self.prof = torch.profiler.profile(activities=acts)
        self.range = None
        self.seconds = 0.0

    def start(self) -> None:
        _sync()
        self.prof.start()
        if self.host:
            self.range = span(STRETCH)
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.seconds = time.perf_counter() - self.t0
        if self.host:
            self.range.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> dict:
        if not self.host:
            return summarize_device(self.prof.events(), self.seconds)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return summarize_host(json.load(f)["traceEvents"])


class Schedule:
    """The traced run's stretches over its items (frames or steps): the
    steady stretch over items [after, after + steady), the attribution
    stretch over the next `attrib`; `hooks()`, called as the attribution
    stretch starts, returns an object whose `close()` ends it."""

    def __init__(self, on: bool, after: int, steady: int, attrib: int, hooks=None) -> None:
        self.on, self.hooks = on, hooks
        self.a0, self.b0, self.b1 = after, after + steady, after + steady + attrib
        self.steady = self.attrib = self.active = self.open_hooks = None
        self.steady_items, self.t_first, self.clean_s = 0, 0.0, 0.0

    def before(self, k: int) -> None:
        if self.on and k == 0:
            self.t_first = time.perf_counter()
        if self.on and k == self.a0:
            _sync()
            self.clean_s = time.perf_counter() - self.t_first
            self.steady = self._begin(Stretch(host=False))
        if self.on and k == self.b0:
            self.attrib = self._begin(Stretch(host=True))
            self.open_hooks = self.hooks() if self.hooks else None

    def after(self, k: int) -> None:
        if self.active is not None:
            self.steady_items += self.active is self.steady
        if k in (self.b0 - 1, self.b1 - 1):
            self.finish()

    def finish(self) -> None:
        if self.active is None:
            return
        self.active.stop()
        if self.active is self.attrib and self.open_hooks is not None:
            self.open_hooks.close()
        self.active = None

    def _begin(self, stretch: Stretch) -> Stretch:
        stretch.start()
        self.active = stretch
        return stretch

    def attrib_items(self, items: int) -> int:
        """How many of `items` the attribution stretch covered."""
        return max(0, min(items, self.b1) - self.b0)

    def rate(self, items: int, seconds: float) -> float:
        """Items per second of the window's items before the first
        stretch; of all `items` over `seconds` where no stretch began."""
        if self.clean_s > 0:
            return self.a0 / self.clean_s
        return items / seconds

    def readings(self, items: int, seconds: float) -> dict:
        """The steady stretch's summary with its `items` and the untraced
        pace's `item_s` (`rate`), and the attribution stretch's
        `idle_gaps`, for a window of `items` over `seconds`."""
        out = self.steady.read() if self.steady else {}
        if out:
            out.update(items=self.steady_items, item_s=1.0 / self.rate(items, seconds))
        if self.attrib:
            out["idle_gaps"] = self.attrib.read().get("idle_gaps", [])
        return out


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _ops(intervals: list) -> list:
    ops = defaultdict(float)
    for a, b, e in intervals:
        ops[group(e.get("name", ""))] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in ops.items()), key=lambda r: -r[1])[:10]


def summarize_device(events, seconds: float) -> dict:
    """A steady stretch's readings from the profiler's events (a CUDA-only
    trace's Chrome export carries no durations): every device event lies in
    the stretch, the card having been synchronised at both ends."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(float(e.time_range.start), float(e.time_range.end), {"name": e.name})
           for e in events if e.device_type == cuda]
    busy = _union([(a, b) for a, b, _ in dev])
    return {"window_s": seconds, "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "device_ops": _ops(dev)}


def summarize_host(events: list) -> dict:
    """An attribution stretch's `idle_gaps` from Chrome-trace `events`
    (times in µs), inside its `bench.stretch` range."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    stretch = [e for e in xs if e.get("name") == STRETCH]
    if not stretch:
        return {}
    w0 = float(stretch[0]["ts"])
    w1 = w0 + float(stretch[0]["dur"])
    clipped = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
               for e in xs if e.get("cat", "").lower() in DEVICE_CATS]
    busy = _union([(a, b) for a, b in clipped if b > a])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    host = [e for e in xs if e.get("cat", "").lower() in HOST_CATS and e.get("name") != STRETCH]
    idle = defaultdict(float)
    for (g0, g1), name in zip(gaps, _host_at([(a + b) / 2 for a, b in gaps], host)):
        idle[name] += (g1 - g0) * 1e-6
    return {"idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda r: -r[1])[:10]}


def _host_at(times: list, host: list) -> list:
    """For each time (sorted), the name of the innermost host event of any
    thread containing it: the one that started last."""
    best = [(float("-inf"), "(no traced host operation)")] * len(times)
    by_thread = defaultdict(list)
    for e in host:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: float(e["ts"]))
        stack, i = [], 0
        for k, t in enumerate(times):
            while i < len(evs) and float(evs[i]["ts"]) <= t:
                stack.append(evs[i])
                i += 1
            while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) < t:
                stack.pop()
            inner = next((e for e in reversed(stack)
                          if float(e["ts"]) + float(e["dur"]) >= t), None)
            if inner is not None and float(inner["ts"]) > best[k][0]:
                best[k] = (float(inner["ts"]), inner["name"])
    return [name for _, name in best]
