"""corr.forward_ms: device-busy milliseconds a training step under the
program's span `corr.forward`: the backbone's forward pass over the
2 x batch clouds, its blocks and BatchNorms included (yardstick/spans.py)."""

from yardstick import spans


def read(ctx):
    return spans.corr_ms(ctx, "corr.forward")
