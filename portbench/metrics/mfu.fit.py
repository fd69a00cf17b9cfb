"""mfu.fit: the fit's share of the card's float32 peak over the window.

Operations counted by the benchmark from the cell's shapes and the
program's launch counters over the window: PAIR_FLOPS a pair of every
Chamfer (nn1_bidir_coords) and flow blend (blend3) launch, the dense
forward and backward of every iteration, and the cost matrix of every
dense assignment solve (the banded solve builds none, and the auction's
bidding is not counted); over the window's host-clock seconds and 67
TFLOP/s, the float32 peak outside the tensor cores (TF32 is off)."""

from yardstick import roofline


def read(ctx):
    cfg, win = ctx["cell"].config, ctx["window"]
    b, n = cfg["n_frames"] - 1, cfg["num_points"]
    m = n // cfg["downsample"]
    launches = win["launches"]
    flops = (roofline.PAIR_FLOPS * b * n * n
             * (launches["nn1_bidir_coords"] + launches["blend3"])
             + win["iterations"] * roofline.dense_fit_flops(
                 b, n, cfg["num_parts"], cfg["hidden"])
             + roofline.lap_cost_flops(b, m, m) * (
                 launches["auction_solve_resident"]
                 + launches["auction_solve_resident_hbm"]
                 + launches["auction_solve_large"]))
    if ctx["device"]["platform"] != "gpu" or win["seconds"] <= 0:
        return None
    return 100.0 * flops / win["seconds"] / roofline.PEAK_F32_FLOPS
