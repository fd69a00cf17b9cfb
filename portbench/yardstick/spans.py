"""Device time and host operators by the program's own spans, read from
the `Trace` of a traced run (yardstick/trace.py).

The program (reart_tpu_torch/profiling.py) makes each span a
`user_annotation` of the trace and launches a mark, an empty one-warp
kernel, on the device's stream at the span's entry and at its exit. So the
marks, in device order, are the span boundaries in host order: the k-th
mark is the k-th boundary of the spans' annotations sorted by time. The
marks cut the device's timeline into intervals; the busy time of each
(the union of the other device operations inside it, from one mark's end
to the next mark's start) belongs to every span open after the boundary
that opened it, so a span's time holds its children's. Where the marks are
not exactly twice the spans, or the boundaries do not nest, nothing is
read (None), never a wrong number; so too for a program that keeps no
spans.

Host operators are the outermost ATen operators (`aten::*` events with no
`aten::*` event around them on their thread) that start inside a span.
"""

from __future__ import annotations

import bisect

from yardstick.trace import _merged

MARK = "empty_kernel"


def program_record() -> dict | None:
    """The program's spans and counters since its last reset
    (`profiling.snapshot()`), or None for a program that keeps none."""
    try:
        from reart_tpu_torch import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return None if snapshot is None else snapshot()


def _overlap(busy, lo, hi, start):
    """Busy seconds of the merged intervals `busy` inside [lo, hi), from
    index `start` on -> (microseconds, the first index still needed)."""
    while start < len(busy) and busy[start][1] <= lo:
        start += 1
    total, j = 0.0, start
    while j < len(busy) and busy[j][0] < hi:
        total += max(0.0, min(busy[j][1], hi) - max(busy[j][0], lo))
        j += 1
    return total, start


def device_seconds(tr, names) -> dict | None:
    """{span name: device-busy seconds under the spans of that name,
    children included} over the trace, the spans being the host events
    named in `names`; None where the marks are not twice the spans or the
    boundaries do not nest."""
    bounds = []
    for name, ts, dur, _ in tr.host_ops:
        if name in names:
            bounds.append((ts, 1, -dur, name))          # entry
            bounds.append((ts + dur, 0, dur, name))     # exit
    bounds.sort()
    marks = sorted((s, s + d) for n, s, d in tr.device_ops if MARK in n)
    if not bounds or len(marks) != len(bounds):
        return None
    busy = _merged([op for op in tr.device_ops if MARK not in op[0]])
    totals = dict.fromkeys(names, 0.0)
    stack, j = [], 0
    for k, ((_, entry, _, name), (_, lo)) in enumerate(zip(bounds, marks)):
        if entry:
            stack.append(name)
        elif stack and stack[-1] == name:
            stack.pop()
        else:
            return None
        hi = marks[k + 1][0] if k + 1 < len(marks) else lo
        us, j = _overlap(busy, lo, hi, j)
        for open_name in set(stack):
            totals[open_name] += 1e-6 * us
    return totals


def outermost_ops(tr, under: str) -> int:
    """The outermost ATen operators that start inside a host event named
    `under`."""
    spans = sorted((ts, ts + dur) for name, ts, dur, _ in tr.host_ops
                   if name == under)
    starts = [s for s, _ in spans]
    ops = sorted((ts, -dur, tid) for name, ts, dur, tid in tr.host_ops
                 if name.startswith("aten::"))
    open_until, n = {}, 0
    for ts, neg_dur, tid in ops:
        if ts < open_until.get(tid, float("-inf")):
            continue                                    # nested
        open_until[tid] = ts - neg_dur
        k = bisect.bisect_right(starts, ts) - 1
        if k >= 0 and ts < spans[k][1]:
            n += 1
    return n


def corr_step(ctx) -> dict | None:
    """The traced training run by the program's spans, once per run:
    {"steps": the program's `corr.steps`, "seconds": device_seconds or None,
    "host_ops": outermost_ops under `corr.step`}; None where the program
    keeps no spans or its step count is not the trace's `corr.step` count."""
    if "spans.corr_step" not in ctx:
        ctx["spans.corr_step"] = _corr_step(ctx["trace"])
    return ctx["spans.corr_step"]


def _corr_step(tr):
    record = program_record()
    if record is None:
        return None
    steps = record["counters"].get("corr.steps", 0)
    if not steps or steps != sum(1 for h in tr.host_ops
                                 if h[0] == "corr.step"):
        return None
    names = {s["name"] for s in record["spans"]}
    return {"steps": steps, "seconds": device_seconds(tr, names),
            "host_ops": outermost_ops(tr, "corr.step")}


def corr_ms(ctx, *names) -> float | None:
    """Device-busy milliseconds a training step under the spans named."""
    per = corr_step(ctx)
    if per is None or per["seconds"] is None:
        return None
    return 1e3 * sum(per["seconds"].get(n, 0.0) for n in names) / per["steps"]
