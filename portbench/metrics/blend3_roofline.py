"""blend3_roofline: the flow blend kernel's share of its bound in the
traced fit, its device time against the frozen bound of each call at
(T-1 frames, N points, N anchors: the flow anchors every point)."""

from yardstick.roofline import traced_roofline


def read(ctx):
    return traced_roofline(ctx, "blend3", "blend3_kernel")
