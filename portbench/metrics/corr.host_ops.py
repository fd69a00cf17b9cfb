"""corr.host_ops: the outermost ATen operators the host issues a
training step (every `aten::*` event with none around it on its thread,
the autograd thread's included, that starts inside a `corr.step` span),
over the program's `corr.steps` (yardstick/spans.py). Read on any
device: it counts host events, not device time."""

from yardstick import spans


def read(ctx):
    per = spans.corr_step(ctx)
    return None if per is None else per["host_ops"] / per["steps"]
