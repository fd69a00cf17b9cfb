"""nn1_bidir_coords_roofline: the Chamfer kernel's share of its bound in
the traced fit, its scan and decode kernels' device time against the
frozen bound of each call at (T-1, N, N)."""

from yardstick.roofline import traced_roofline


def read(ctx):
    return traced_roofline(ctx, "nn1_bidir_coords", "nn1_bidir_")
