"""Farthest-point-sampling kernel (csrc/fps.cu) with its plain PyTorch
version; counterpart of reart_tpu/ops/pallas_fps.py.

`fps` takes the plain loop for a CPU tensor and launches the kernel for a
CUDA tensor (or raises); `fps.launches` counts kernel launches. Both give the
same selection order bit for bit: the start is the first masked index (0
when nothing is masked), distances are (dx^2 + dy^2) + dz^2 in float32, and
ties go to the lowest index.
"""

from __future__ import annotations

import torch

from reart_tpu_torch.ops import _build

# the kernel keeps the cloud and its running distances in shared memory,
# 16 bytes a point, within the 227 KB a block may use on sm_90
MAX_POINTS = 14336


def fps_plain(xyz: torch.Tensor, mask: torch.Tensor, npoint: int):
    """xyz (B, N, 3) float32, mask (B, N) bool -> (B, npoint) int64."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    dist = torch.full((b, n), float("inf"), dtype=xyz.dtype,
                      device=xyz.device)
    neg_inf = torch.tensor(float("-inf"), dtype=xyz.dtype, device=xyz.device)
    out = torch.zeros((b, npoint), dtype=torch.int64, device=xyz.device)
    far = torch.argmax(mask.to(torch.int32), dim=1)  # first masked, else 0
    for i in range(npoint):
        out[:, i] = far
        c = xyz[rows, far]                                   # (B, 3)
        d = None
        for k in range(3):
            diff = xyz[..., k] - c[:, k:k + 1]
            d = diff * diff if d is None else d + diff * diff
        dist = torch.minimum(dist, d)
        far = torch.argmax(torch.where(mask, dist, neg_inf), dim=1)
    return out


def fps(xyz: torch.Tensor, mask: torch.Tensor, npoint: int):
    """Masked FPS; see fps_plain."""
    name = "fps"
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or mask.shape != xyz.shape[:2]:
        raise ValueError(f"{name}: expected xyz (B, N, 3) and mask (B, N), "
                         f"got {tuple(xyz.shape)} and {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise ValueError(f"{name}: mask must be bool, got {mask.dtype}")
    if not 0 < npoint:
        raise ValueError(f"{name}: npoint must be positive, got {npoint}")
    if _build.is_cpu(name, xyz):
        return fps_plain(xyz, mask, npoint)
    _build.require_cuda(name, xyz, dtype=torch.float32)
    _build.require_cuda(name, mask, dtype=torch.bool)
    b, n, _ = xyz.shape
    if n > MAX_POINTS:
        raise ValueError(f"{name}: the kernel holds at most {MAX_POINTS} "
                         f"points per cloud in shared memory, got {n}")
    out = torch.empty((b, npoint), dtype=torch.int64, device=xyz.device)
    lib = _build.load_library()
    with torch.cuda.device(xyz.device):
        err = lib.reart_fps(xyz.data_ptr(), mask.data_ptr(), b, n, npoint,
                            out.data_ptr(), _build.stream_of(xyz))
    _build.check_launch(name, err)
    fps.launches += 1
    return out


fps.launches = 0
