"""corr.update_ms: device-busy milliseconds a training step under the
program's span `corr.update`: Adam's step and the running statistics'
update (apply_bn_ema) (yardstick/spans.py)."""

from yardstick import spans


def read(ctx):
    return spans.corr_ms(ctx, "corr.update")
