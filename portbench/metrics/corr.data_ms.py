"""corr.data_ms: device-busy milliseconds a training step under the
program's spans `corr.draws` (the random draws) and `corr.synth` (the
synthetic pair: the Voronoi split, the screws, the jitter), from the
traced run's marks (yardstick/spans.py)."""

from yardstick import spans


def read(ctx):
    return spans.corr_ms(ctx, "corr.draws", "corr.synth")
