"""device.idle_pct.train: the share of the traced training run's window in which no
operation ran on the device (1 - busy / window, busy the union of the
device's kernel, copy and set intervals), under the profiler."""

from yardstick.trace import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"])
