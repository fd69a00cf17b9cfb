"""Per-sequence test-time optimisation engine: the relaxation (base) fit
and the projection (kinematic) fit; the trainer of the correspondence
backbone (train/corr.py)."""

from reart_tpu_torch.train.corr import (
    CorrTrainConfig,
    corr_info_nce,
    draw_pairs,
    finetune_real_pairs,
    match_precision,
    mine_pair_labels,
    synth_pair,
    train_corr,
)
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
    "AssignContext", "CorrTrainConfig", "FitConfig", "FlowContext",
    "build_assign_context", "corr_info_nce", "draw_pairs",
    "finetune_real_pairs", "fit", "fit_base", "fit_kinematic",
    "make_optimizer", "match_precision", "mine_pair_labels", "synth_pair",
    "tau_cosine", "train_corr",
]
