"""corr.backward_ms: device-busy milliseconds a training step under the
program's span `corr.backward`: the whole backward pass, the BatchNorms'
backward spans included (yardstick/spans.py)."""

from yardstick import spans


def read(ctx):
    return spans.corr_ms(ctx, "corr.backward")
