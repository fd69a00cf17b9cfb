"""Batched fits on one card: the counterpart of reart_tpu/parallel/.

The JAX package shards independent fits over a device mesh; here they are
rows of one program on one device (parallel/rows.py). The mesh plumbing
(`make_mesh`, `batch_spec`, `replicated_spec`) is not ported.
"""

from reart_tpu_torch.parallel.rows import (
    BaseRows,
    fit_base_candidates,
    fit_base_sequences,
    fit_batch,
    init_batched_params,
    make_batched_fit_step,
    rows_forward,
)

__all__ = [
    "BaseRows", "fit_base_candidates", "fit_base_sequences", "fit_batch",
    "init_batched_params", "make_batched_fit_step", "rows_forward",
]
