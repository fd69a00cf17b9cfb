"""corr.bn_ms: device-busy milliseconds a training step under every
`bn` span of the program: the written-out BatchNorm of the backbone's 25
conv layers (moments, normalise, scale, ReLU) in the forward pass, and its
backward, bounded by two tensor hooks on the autograd thread
(yardstick/spans.py)."""

from yardstick import spans


def read(ctx):
    return spans.corr_ms(ctx, "bn")
