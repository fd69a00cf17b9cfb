"""Per-sequence test-time optimisation engine. Slice 1 ports the
relaxation (base) fit; the kinematic fit and the corr trainer follow."""

from reart_tpu_torch.train.engine import (
    AssignContext,
    FitConfig,
    FlowContext,
    build_assign_context,
    fit,
    fit_base,
    make_optimizer,
)
from reart_tpu_torch.train.schedules import tau_cosine

__all__ = [
    "AssignContext", "FitConfig", "FlowContext", "build_assign_context",
    "fit", "fit_base", "make_optimizer", "tau_cosine",
]
