"""corr.loss_ms: device-busy milliseconds a training step under the
program's span `corr.loss`: the features normalised, the radius gates, the
(N, N) logits and the bidirectional InfoNCE (yardstick/spans.py)."""

from yardstick import spans


def read(ctx):
    return spans.corr_ms(ctx, "corr.loss")
