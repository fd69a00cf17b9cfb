"""Per-phase wall-clock (reart_tpu/profiling.py).

    with phase_timer("fit"):   # prints and records seconds
        ...
    phase_report()             # {"fit": seconds, ...}
"""

from __future__ import annotations

import contextlib
import time

import torch

_PHASES: dict[str, float] = {}


def _wait_for_device() -> None:
    """A phase ends when the device has finished its work, not when the
    host has queued it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase_timer(name: str, verbose: bool = True):
    """Wall-clock a pipeline phase; durations accumulate in `phase_report`."""
    _wait_for_device()
    t0 = time.perf_counter()
    try:
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
