"""mfu.train: the backbone training's share of the card's float32 peak
over the window.

Operations counted by the benchmark from the configuration's shapes: every
1x1 convolution of PointNet2Msg2 on the rows it sees (2 x batch clouds;
SA1 512 centroids x 32/64/128 neighbours, SA2 128 x 64/128, SA3 the 128
centroids, FP3 128, FP2 512, FP1 and the head every point), a multiply
and an add per weight and row, paid three times with the backward; and
the InfoNCE logits (batch x N x N x out_dim, the same). BatchNorm,
gathers and the neighbour searches are not counted, so the share errs
low. Over the window's host-clock seconds and 67 TFLOP/s, the float32
peak outside the tensor cores (TF32 is off)."""

from reference.corr import SA1, SA2, layer_shapes
from yardstick import roofline


def step_flops(corr: dict) -> float:
    b2, n, out_dim = 2 * corr["batch"], corr["n_points"], corr["out_dim"]
    rows = {}
    for name, spec, centres in (("sa1", SA1, SA1[0]), ("sa2", SA2, SA2[0])):
        for bi, k in enumerate(spec[2]):
            rows[f"{name}.{bi}"] = b2 * centres * k
    rows.update(sa3=b2 * SA2[0], fp3=b2 * SA2[0], fp2=b2 * SA1[0],
                fp1=b2 * n, head=b2 * n)
    flops = 0.0
    for layer, (c_in, c_out) in layer_shapes(out_dim).items():
        parts = layer.split(".")
        key = ".".join(parts[:2]) if parts[0] in ("sa1", "sa2") else parts[0]
        flops += 2.0 * rows[key] * c_in * c_out
    logits = 2.0 * corr["batch"] * n * n * out_dim
    return 3.0 * (flops + logits)


def read(ctx):
    win = ctx["window"]
    if ctx["device"]["platform"] != "gpu" or win["seconds"] <= 0:
        return None
    flops = win["steps"] * step_flops(ctx["cell"].config["corr"])
    return 100.0 * flops / win["seconds"] / roofline.PEAK_F32_FLOPS
