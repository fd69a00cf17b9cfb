"""The readers of the program's spans (yardstick/spans.py and the corr.*
metrics): a hand-made trace with marks and annotations, a mark too many or
too few, and the tiny corr cell's traced run on the CPU."""

import os

import pytest

from conftest import BENCH

import run as harness
from yardstick import spans
from yardstick.trace import Trace

MARK = "(anonymous namespace)::empty_kernel()"

# one training step: (name, host start, host end, thread); the backward's
# `bn` runs on the autograd thread (2)
ANNOTATIONS = [("corr.step", 0, 100, 1), ("corr.draws", 5, 15, 1),
               ("corr.forward", 20, 60, 1), ("bn", 30, 40, 1),
               ("corr.backward", 65, 85, 1), ("bn", 70, 80, 2)]
# the busy microseconds the device spends after each of the 12 boundaries
# in host order, up to the next mark: the last interval (after the step's
# exit) belongs to no span
AFTER = [2, 3, 0, 4, 5, 1, 0, 2, 6, 0, 1, 7]
OPS = [("aten::mm", 21, 4, 1), ("aten::addmm", 22, 2, 1),   # nested: 1
       ("aten::add", 71, 1, 2), ("aten::mul", 73, 1, 2),    # autograd: 2
       ("aten::zeros", 110, 1, 1)]                         # after the step


def _trace(after=AFTER, extra_marks=0):
    device, t = [], 1000.0
    for busy in after:
        device.append((MARK, t, 1.0))
        if busy:
            device.append(("void at::native::reduce_kernel", t + 2, busy))
        t += 10.0
    device += [(MARK, t + 10.0 * i, 1.0) for i in range(extra_marks)]
    host = [(n, s, e - s, tid) for n, s, e, tid in ANNOTATIONS] + OPS
    return Trace(window_s=1e-3, busy_s=0.0, device_ops=device,
                 host_ops=host, window=(0.0, 2000.0), wall_s=1e-3)


NAMES = {n for n, *_ in ANNOTATIONS}


def test_each_interval_belongs_to_the_spans_open_after_its_mark():
    got = spans.device_seconds(_trace(), NAMES)
    assert got == pytest.approx({
        "corr.step": 24e-6, "corr.draws": 3e-6, "corr.forward": 10e-6,
        "bn": 11e-6, "corr.backward": 8e-6})


def test_host_ops_are_the_outermost_aten_operators_inside_a_step():
    assert spans.outermost_ops(_trace(), "corr.step") == 3


@pytest.mark.parametrize("trace", [
    _trace(extra_marks=1), _trace(after=AFTER[:-1])])
def test_a_mark_too_many_or_too_few_reads_nothing(trace):
    assert spans.device_seconds(trace, NAMES) is None


@pytest.fixture
def two_steps(monkeypatch):
    """The program's record of the hand-made trace, counted as 2 steps
    (the trace holds one corr.step: a mismatch), or as 1."""
    def record(steps):
        return {"spans": [{"name": n} for n, *_ in ANNOTATIONS],
                "counters": {"corr.steps": steps}}

    def use(steps):
        monkeypatch.setattr(spans, "program_record", lambda: record(steps))
        return {"trace": _trace()}
    return use


def test_the_metrics_read_per_step(two_steps):
    ctx = two_steps(1)
    got = {name: harness._load_module(
        os.path.join(BENCH, "metrics", f"{name}.py"), name).read(ctx)
        for name in ("corr.data_ms", "corr.forward_ms", "corr.bn_ms",
                     "corr.loss_ms", "corr.backward_ms", "corr.update_ms",
                     "corr.host_ops")}
    assert got == pytest.approx({
        "corr.data_ms": 3e-3, "corr.forward_ms": 10e-3, "corr.bn_ms": 11e-3,
        "corr.loss_ms": 0.0, "corr.backward_ms": 8e-3,
        "corr.update_ms": 0.0, "corr.host_ops": 3.0})


def test_a_step_count_the_trace_does_not_hold_reads_nothing(two_steps):
    assert spans.corr_ms(two_steps(2), "bn") is None
    assert spans.corr_step(two_steps(2)) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "program_record", lambda: None)
    assert spans.corr_step({"trace": _trace()}) is None


def test_the_tiny_corr_cells_traced_run_on_the_cpu(tiny_bench):
    # no marks on the CPU: the device readers find nothing; the host
    # operators are counted. The program's record is the process's since
    # its last reset, and other tests trace too: this run starts it anew
    from reart_tpu_torch import profiling

    profiling.reset()
    res = harness.run("tiny.corr", 2 ** 31 + 3, 0.0, True, device="cpu",
                      bench_dir=tiny_bench)
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert metrics["corr.host_ops"]["unit"] == "ops"
    assert metrics["corr.host_ops"]["value"] > 100
    assert not {k for k in metrics if k.endswith("_ms")}
