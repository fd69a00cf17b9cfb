"""Per-sequence test-time optimisation engine: the relaxation (base) fit
and the projection (kinematic) fit; the corr trainer follows."""

from reart_tpu_torch.train.engine import (
    AssignContext,
    FitConfig,
    FlowContext,
    build_assign_context,
    fit,
    fit_base,
    fit_kinematic,
    make_optimizer,
)
from reart_tpu_torch.train.schedules import tau_cosine

__all__ = [
    "AssignContext", "FitConfig", "FlowContext", "build_assign_context",
    "fit", "fit_base", "fit_kinematic", "make_optimizer", "tau_cosine",
]
