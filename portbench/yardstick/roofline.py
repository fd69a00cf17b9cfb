"""Peaks, kernel bounds and operation counts: the benchmark's yardstick.

The peaks and `bound_of` are a frozen copy of reart_tpu_torch/bench_nn.py's
(NVIDIA's H100 SXM data sheet at 700 W: 67 TFLOP/s float32 outside the
tensor cores, which is the peak that counts while TF32 is off, and 3.35
TB/s of HBM). A kernel's bound is the larger of its operations over the
float32 peak and its bytes over the memory rate, each input read once and
each output written once. A neighbour kernel costs PAIR_FLOPS a (query,
reference) pair: three differences, three products, two sums.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PAIR_FLOPS = 8

F32, I64 = 4, 8


def bound_of(flops: float, nbytes: float) -> dict:
    """The least time (ms) the card could take: the larger of `flops` over
    the float32 peak and `nbytes` over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nn1_bidir_coords_cost(b: int, n: int, m: int) -> tuple[float, float]:
    """(flops, bytes) of one (B, N, M) bidirectional 1-NN with coordinates:
    every pair once; the two clouds read, and each direction's distance,
    int64 index and coordinates written."""
    return (PAIR_FLOPS * b * n * m,
            F32 * 3 * b * (n + m) + (F32 + I64 + 3 * F32) * b * (n + m))


def blend3_cost(b: int, n: int, m: int) -> tuple[float, float]:
    """(flops, bytes) of one (B, N, M) 3-NN flow blend: every pair once;
    the queries, anchors and flows read, the blended flow, the nearest
    distance and the largest flow norm written."""
    return (PAIR_FLOPS * b * n * m,
            F32 * 3 * b * (n + 2 * m) + F32 * b * n * (3 + 1 + 1))


def kernel_bound_ms(kernel: str, b: int, n: int, m: int) -> float:
    cost = {"nn1_bidir_coords": nn1_bidir_coords_cost,
            "blend3": blend3_cost}[kernel](b, n, m)
    return bound_of(*cost)["bound_ms"]


def dense_fit_flops(frames: int, points: int, parts: int,
                    hidden: int) -> float:
    """Operations of one relaxation-model forward and backward outside the
    neighbour kernels, counted from the shapes: the seg MLP (3 -> hidden ->
    parts, a multiply and an add per weight and point), the per-point blend
    of the parts' 3 x 4 transforms and its application, each forward
    product paid three times with its backward (the weights' and the
    inputs' gradients)."""
    mlp = 2 * points * (3 * hidden + hidden * parts)
    blend = 2 * frames * points * parts * 12 + 2 * frames * points * 12
    return 3.0 * (mlp + blend)


def lap_cost_flops(b: int, n: int, m: int) -> float:
    """Operations of the dense assignment's euclidean cost matrix: the
    product x.y (2 x 3 a pair), the norms' sum and scale (4) and the root
    (1). The auction's own bidding is data-dependent and not counted, so
    a share of the peak built on this errs low."""
    return 11.0 * b * n * m


def traced_roofline(ctx, kernel: str, *fragments):
    """A kernel's share of its bound in a traced fit: its calls (the
    wrapper's launch counter) times the bound of one call at the cell's
    shape (T-1 frames, N points against N points), over the device time of
    the kernels whose names hold `fragments`; None where none ran."""
    cfg, calls = ctx["cell"].config, ctx["traced"]["launches"][kernel]
    seconds, _ = ctx["trace"].seconds_of(*fragments)
    if seconds <= 0 or calls <= 0:
        return None
    b, n = cfg["n_frames"] - 1, cfg["num_points"]
    return 100.0 * calls * kernel_bound_ms(kernel, b, n, n) / (1e3 * seconds)
