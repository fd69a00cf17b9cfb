"""The traced window: a torch.profiler window reduced to device time.

The device-time arithmetic is chip_smoke.py's (`device_time_by_name`,
`log_fit_window`), copied and reduced from the profiler's Chrome trace
rather than from `key_averages()`, so that busy time is the union of the
device's intervals (overlapping kernels count once) and every idle gap can
be named by the host operator that was running across it.

`traced(fn)` runs fn() under the profiler inside a `portbench.window`
annotation and returns a `Trace`: the window's length, the device's busy
seconds, each device operation (kernel, copy, set) with its start and
duration, and the host operators.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list      # (name, start_us, dur_us), in start order
    host_ops: list        # (name, start_us, dur_us, thread)
    window: tuple         # (start_us, end_us)
    wall_s: float         # host clock around fn()

    def seconds_of(self, *fragments) -> tuple[float, int]:
        """(device seconds, count) of the device operations whose name holds
        any of `fragments` (a demangled or a mangled name)."""
        hits = [d for name, _, d in self.device_ops
                if any(f in name for f in fragments)]
        return 1e-6 * sum(hits), len(hits)

    def by_name(self) -> dict:
        out = {}
        for name, _, d in self.device_ops:
            out[name] = out.get(name, 0.0) + 1e-6 * d
        return out

    def idle_gaps(self) -> dict:
        """{host operator: idle seconds}: each gap between the device's
        merged busy intervals inside the window, named by the innermost
        host operator running at its midpoint."""
        gaps, (lo, hi) = [], self.window
        cursor = lo
        for start, end in _merged(self.device_ops):
            if start > cursor:
                gaps.append((cursor, start))
            cursor = max(cursor, end)
        if hi > cursor:
            gaps.append((cursor, hi))
        out = {}
        for (g0, g1), name in zip(gaps, _innermost(
                self.host_ops, [0.5 * (g0 + g1) for g0, g1 in gaps])):
            out[name] = out.get(name, 0.0) + 1e-6 * (g1 - g0)
        return out

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[k[:160], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(self.by_name()),
                "idle_gaps": head(self.idle_gaps())}


def _innermost(host_ops, times):
    """For each time (ascending), the name of the innermost host operator
    running then: per thread a stack of the operators open at that time
    (operators of one thread nest), the most recently opened of the
    threads' innermost ones; "(python between operators)" where none
    runs."""
    hosts = sorted(host_ops, key=lambda h: h[1])
    stacks, names, i = {}, [], 0
    for t in times:
        while i < len(hosts) and hosts[i][1] <= t:
            name, start, dur, tid = hosts[i]
            stack = stacks.setdefault(tid, [])
            while stack and stack[-1][1] < start:
                stack.pop()
            if name != WINDOW:
                stack.append((start, start + dur, name))
            i += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        names.append(best[2] if best else "(python between operators)")
    return names


def _merged(device_ops):
    spans = sorted((s, s + d) for _, s, d in device_ops)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(fn, cuda: bool) -> Trace:
    """Run fn() under torch.profiler (the card's activity too with `cuda`)
    and reduce its trace; the trace file lives in a temporary directory
    under TMPDIR only while it is read."""
    import torch
    from torch import profiler

    acts = [profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(profiler.ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        with profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with profiler.record_function(WINDOW):
                fn()
                if cuda:
                    torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    window = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((name, ts, dur))
        elif cat in HOST_CATS:
            if name == WINDOW and cat == "user_annotation":
                window = (ts, ts + dur)
            host.append((name, ts, dur, e.get("tid", 0)))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window annotation")
    lo, hi = window
    device = sorted(((n, s, d) for n, s, d in device if lo <= s < hi),
                    key=lambda x: x[1])
    busy = sum(e - s for s, e in _merged(device))
    return Trace(window_s=1e-6 * (hi - lo), busy_s=1e-6 * busy,
                 device_ops=device, host_ops=host, window=window,
                 wall_s=wall)


def idle_pct(tr: Trace):
    """The share of a traced window in which no operation ran on the
    device (1 - busy / window), or None where the trace saw none."""
    if tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
