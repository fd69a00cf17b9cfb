"""The port's tracing: per-phase wall clock, spans and counters, and the
profiler trace that carries them (reart_tpu/profiling.py).

    with phase_timer("fit"):   # prints and records seconds
        ...
    phase_report()             # {"fit": seconds, ...}
    with device_trace(dir):    # a torch.profiler Chrome trace and
        ...                    # spans.json in dir
    with span("corr.step", device):
        ...
    count("lap.sweeps", n)     # a host int, or a device tensor

Tracing is on exactly while a torch.profiler session records (this
module's `device_trace`, or anyone's) or inside `tracing()`, and off
otherwise. Off, `span` costs one flag test and returns a shared no-op
context, and `count` one flag test: no allocation, no annotation, no hook,
no launch.

On, a span
  * enters `torch.profiler.record_function(name)`, so its start and end are
    the trace's `user_annotation` event, on the clock of the kernels;
  * records (id, parent id, name, thread) in memory. The parent is the
    innermost span open on the thread; on a thread with none open (the
    autograd engine's) the main thread's innermost, the span that was open
    when `backward()` was called;
  * launches a mark, the one-warp `reart_empty_kernel`
    (csrc/launch_floor.cu), on the current stream of a CUDA `device` at
    entry and at exit, so that the device's timeline carries every span
    boundary in stream order. No mark is launched while a CUDA graph is
    being captured.

Counters add host integers, or device tensors that are summed on the
device and read once, by `snapshot`. The kernel wrappers keep their own
`.launches`; `snapshot` reads them. `device_trace` writes `spans.json`
beside its trace: the span tree with each span's `ts` / `dur` taken from
its own annotation (the Chrome trace's microseconds), the counters, and
the wrappers' launches over the session. Both `device_trace` and
`tracing()` start from an empty record; spans and counters of another
profiler session add to what the last of them left.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gzip
import json
import os
import re
import socket
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_PHASES: dict[str, float] = {}
_MAIN = threading.main_thread().ident


class _Record:
    """What the spans and counters recorded since the last reset."""

    def __init__(self):
        self.forced = False
        self.lock = threading.Lock()
        self.reset()

    def reset(self, launches0: dict | None = None) -> None:
        self.spans = []            # (id, parent id or None, name, thread)
        self.stacks = {}           # thread ident -> ids of the open spans
        self.counts = {}           # name -> int
        self.device_counts = {}    # (name, device) -> int64 0-d tensor
        self.marks = 0
        self.launches0 = launches0 or {}


_REC = _Record()
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether tracing is on: a torch.profiler session records, or
    `tracing()` is open."""
    return _REC.forced or _autograd_profiler._is_profiler_enabled


@functools.lru_cache(maxsize=None)
def _mark_kernel():
    from reart_tpu_torch.ops import _build

    return _build.load_library().reart_empty_kernel, _build.check_launch


def _mark(device) -> None:
    if (device is None or device.type != "cuda"
            or torch.cuda.is_current_stream_capturing()):
        return
    launch, check = _mark_kernel()
    check("span mark", launch(ctypes.c_void_p(
        torch.cuda.current_stream(device).cuda_stream)))
    with _REC.lock:
        _REC.marks += 1


class _Span:
    """An open span; see the module's docstring."""

    __slots__ = ("name", "device", "rf", "id", "ident")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ident = threading.get_ident()
        with _REC.lock:
            stack = _REC.stacks.setdefault(self.ident, [])
            outer = stack or _REC.stacks.get(_MAIN)
            self.id = len(_REC.spans)
            _REC.spans.append((self.id, outer[-1] if outer else None,
                               self.name, threading.get_native_id()))
            stack.append(self.id)
        _mark(self.device)
        return self

    def __exit__(self, *exc):
        _mark(self.device)
        with _REC.lock:
            stack = _REC.stacks.get(self.ident, [])
            if self.id in stack:
                stack.remove(self.id)
        self.rf.__exit__(None, None, None)
        return False


def span(name: str, device=None):
    """A traced region named `name` (see the module's docstring); `device`
    (a torch.device) is where its marks go, none for a CPU device or
    None. Off, the shared no-op context."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


def backward_span(name: str, first: torch.Tensor, last: torch.Tensor):
    """A span of the backward pass, bounded by two tensors of the forward:
    it opens when `first`'s gradient arrives and closes when `last`'s has
    been summed (`first` computed from `last`). Two tensor hooks, each
    returning None, registered only when tracing is on and both tensors
    take a gradient."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled) \
            or not (first.requires_grad and last.requires_grad):
        return
    device, opened = first.device, []

    def open_(_grad):
        if enabled():
            opened.append(_Span(name, device).__enter__())

    def close(_grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    first.register_hook(open_)
    last.register_hook(close)


def count(name: str, n=1) -> None:
    """Add `n` to the counter `name`: a host int, or a tensor whose sum is
    taken on its device and read by `snapshot`. Off, nothing."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return
    if isinstance(n, torch.Tensor):
        total = n.detach().sum(dtype=torch.int64)
        key = (name, total.device)
        with _REC.lock:
            prev = _REC.device_counts.get(key)
            _REC.device_counts[key] = total if prev is None else prev + total
        return
    with _REC.lock:
        _REC.counts[name] = _REC.counts.get(name, 0) + int(n)


def _launch_counts() -> dict:
    """Every kernel wrapper's `.launches`, by the wrapper's name."""
    from reart_tpu_torch.ops import cuda_auction, cuda_bn, cuda_fps, cuda_nn

    return {name: fn.launches
            for mod in (cuda_auction, cuda_bn, cuda_fps, cuda_nn)
            for name, fn in vars(mod).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int)}


def reset() -> None:
    """Forget the spans and counters recorded so far."""
    with _REC.lock:
        _REC.reset(_launch_counts())


def snapshot() -> dict:
    """What was recorded since the last reset: {"spans": [{"id", "parent",
    "name", "thread"}, ...] in entry order, "counters": {name: int} (the
    device counters read back here), "launches": {wrapper: launches since},
    "marks": marks launched}."""
    with _REC.lock:
        spans = list(_REC.spans)
        counts = dict(_REC.counts)
        device_counts = dict(_REC.device_counts)
        marks, launches0 = _REC.marks, dict(_REC.launches0)
    for (name, _), total in device_counts.items():
        counts[name] = counts.get(name, 0) + int(total)
    launches = {k: v - launches0.get(k, 0)
                for k, v in _launch_counts().items()}
    return {"spans": [{"id": i, "parent": p, "name": n, "thread": t}
                      for i, p, n, t in spans],
            "counters": counts,
            "launches": {k: v for k, v in launches.items() if v},
            "marks": marks}


@contextlib.contextmanager
def tracing():
    """Tracing on without a profiler (spans, marks, counters, hooks), from
    an empty record: for tests and for measuring what tracing costs."""
    reset()
    _REC.forced = True
    try:
        yield
    finally:
        _REC.forced = False


def _wait_for_device() -> None:
    """A phase ends when the device has finished its work, not when the
    host has queued it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _current_cuda():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return None


@contextlib.contextmanager
def phase_timer(name: str, verbose: bool = True):
    """Wall-clock a pipeline phase; durations accumulate in `phase_report`.
    With tracing on the phase is a span too."""
    _wait_for_device()
    t0 = time.perf_counter()
    try:
        with span(name, _current_cuda()):
            yield
    finally:
        _wait_for_device()
        dt = time.perf_counter() - t0
        _PHASES[name] = _PHASES.get(name, 0.0) + dt
        if verbose:
            print(f"[phase] {name}: {dt:.2f}s", flush=True)


def phase_report() -> dict[str, float]:
    return dict(_PHASES)


def reset_phases() -> None:
    _PHASES.clear()


def _annotation_times(prof, trace_path: str, names) -> dict:
    """{name: [(ts, dur), ...] in start order}: the host `user_annotation`
    events of the session with those names, in the Chrome trace's
    microseconds (nanoseconds since its `baseTimeNanoseconds`, read from
    the trace's head). {} where the head has no base."""
    with gzip.open(trace_path, "rt") as f:
        found = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)',
                          f.read(1 << 16))
    if found is None:
        return {}
    base = int(found.group(1))
    out = {}
    for e in prof.profiler.kineto_results.events():
        if (e.name() in names
                and e.device_type() == torch.autograd.DeviceType.CPU):
            out.setdefault(e.name(), []).append(
                ((e.start_ns() - base) / 1000.0, e.duration_ns() / 1000.0))
    for times in out.values():
        times.sort()
    return out


def _write_spans(path: str, prof, trace_path: str) -> dict:
    """`snapshot()` with each span's `ts` and `dur` from its annotation in
    the trace at `trace_path` (the k-th span of a name is that name's k-th
    annotation; null where the trace has none), written to `path` as
    JSON. Returns what it wrote."""
    snap = snapshot()
    times = _annotation_times(prof, trace_path,
                              {s["name"] for s in snap["spans"]})
    seen = {}
    for s in snap["spans"]:
        k = seen.get(s["name"], 0)
        seen[s["name"]] = k + 1
        mine = times.get(s["name"], [])
        s["ts"], s["dur"] = mine[k] if k < len(mine) else (None, None)
    with open(path, "w") as f:
        json.dump(snap, f)
    return snap


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: bool | None = None):
    """A torch.profiler trace around a region, written to `log_dir` as a
    gzipped Chrome trace (`<host>_<pid>.<ms>.pt.trace.json.gz`, which
    Perfetto and TensorBoard read), and the region's spans and counters as
    `spans.json` beside it (see `_write_spans`). Host activity always, the
    card's kernels too with `cuda` (default: when a CUDA device is
    available)."""
    from torch import profiler

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)

    def ready(prof):
        path = os.path.join(
            log_dir, f"{socket.gethostname()}_{os.getpid()}."
                     f"{time.time_ns() // 1_000_000}.pt.trace.json.gz")
        prof.export_chrome_trace(path)
        _write_spans(os.path.join(log_dir, "spans.json"), prof, path)

    reset()
    with profiler.profile(activities=activities, on_trace_ready=ready):
        yield
