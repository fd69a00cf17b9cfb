"""Resident auction kernel (csrc/auction.cu) with its plain PyTorch version;
counterpart of reart_tpu/ops/pallas_auction.py's `auction_solve_resident`.

`auction_solve_resident` takes the plain epsilon-phase loop for a CPU tensor
and launches the kernel for a CUDA tensor (or raises);
`auction_solve_resident.launches` counts kernel launches. Both return the
same row_to_col and prices: the kernel keeps the TPU kernel's column-owner
state, the plain version the row-map sweep of ops/assignment._auction_phase,
and the two are the same auction.
"""

from __future__ import annotations

import ctypes

import torch

from reart_tpu_torch.ops import _build

# the TPU kernel's VMEM window (benefit tile N*M <= 4 MB float32): larger
# problems took the HBM-streaming or the banded solve there, ported later
RESIDENT_MAX_ELEMS = 1024 * 1024
MAX_EPS = 8
# shared memory: 16 bytes per column plus one per row within 227 KB
_MAX_SMEM = 232448 - 1024


def auction_solve_resident_plain(benefit: torch.Tensor, price: torch.Tensor,
                                 eps_list, max_sweeps: int):
    """benefit (B, N, M), price (B, M) -> (row_to_col (B, N) int64, -1 for
    rows unassigned at the sweep bound; final prices (B, M))."""
    from reart_tpu_torch.ops.assignment import _auction_phase

    for eps in eps_list:
        row_to_col, price = _auction_phase(benefit, price, eps, max_sweeps)
    return row_to_col, price


def auction_solve_resident(benefit: torch.Tensor, price: torch.Tensor,
                           eps_list, max_sweeps: int):
    """Full epsilon-scaled auction; see auction_solve_resident_plain.
    eps_list runs from the largest epsilon to the smallest."""
    name = "auction_solve_resident"
    if (benefit.dim() != 3
            or price.shape != (benefit.shape[0], benefit.shape[2])):
        raise ValueError(f"{name}: expected benefit (B, N, M) and price "
                         f"(B, M), got {tuple(benefit.shape)} and "
                         f"{tuple(price.shape)}")
    b, n, m = benefit.shape
    if not 0 < n <= m:
        raise ValueError(f"{name}: needs 0 < N <= M, got N={n}, M={m}")
    eps_list = tuple(float(e) for e in eps_list)
    if not 0 < len(eps_list) <= MAX_EPS:
        raise ValueError(f"{name}: 1 to {MAX_EPS} epsilon phases, got "
                         f"{len(eps_list)}")
    if _build.is_cpu(name, benefit):
        return auction_solve_resident_plain(benefit, price, eps_list,
                                            max_sweeps)
    _build.require_cuda(name, benefit, price, dtype=torch.float32)
    if n * m > RESIDENT_MAX_ELEMS or 16 * m + n > _MAX_SMEM:
        raise NotImplementedError(
            f"{name}: a {n}x{m} LAP is past the dense resident window "
            f"(N*M <= 1024^2); the HBM-streaming and banded auction kernels "
            f"are ported in slice 4")
    r2c = torch.empty((b, n), dtype=torch.int64, device=benefit.device)
    price_out = torch.empty((b, m), dtype=torch.float32,
                            device=benefit.device)
    eps_arr = (ctypes.c_float * len(eps_list))(*eps_list)
    lib = _build.load_library()
    with torch.cuda.device(benefit.device):
        err = lib.reart_auction_resident(
            benefit.data_ptr(), price.data_ptr(), b, n, m,
            ctypes.cast(eps_arr, ctypes.c_void_p),
            len(eps_list), int(max_sweeps), r2c.data_ptr(),
            price_out.data_ptr(), _build.stream_of(benefit))
    _build.check_launch(name, err)
    auction_solve_resident.launches += 1
    return r2c, price_out


auction_solve_resident.launches = 0
