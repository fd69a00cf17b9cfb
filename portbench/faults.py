"""Faults planted in the program, to show that the comparison catches them.

Each fault patches the timed path underneath the harness (through pytest's
monkeypatch in the tests, through `planted` on the card); a run of a cell
that can have it must then come out not correct. A driver's `FAULTS` names
those its cells can have (one chip: there is no exchange between chips to
leave out).

  state_unchanged   the optimizer step returns the weights unchanged
  half_batch        the loss sees half the batch, its mean over the rest:
                    the fit's Chamfer half the frames (doubled), the
                    backbone's InfoNCE half the pairs
  altered_solve     every fit's assignment solve returns its matching
                    shifted by one row
  altered_energy    the selection energy's exact LAP returns its matching
                    shifted by one row
  altered_grouping  the backbone's ball query returns each group's
                    indices shifted to the next point
"""

from __future__ import annotations

import contextlib


def _patches(name: str):
    import torch

    if name == "state_unchanged":
        def step(self, closure=None):
            return None
        return [(torch.optim.Adam, "step", step)]
    if name == "half_batch":
        from reart_tpu_torch.train import corr, engine

        recon = engine.recon_loss
        nce = corr.corr_info_nce

        def recon_loss(pred, frames):
            h = max(pred.shape[0] // 2, 1)
            return (pred.shape[0] / h) * recon(pred[:h], frames[:h])

        def corr_info_nce(model, src, tgt, *args, **kwargs):
            h = max(src.shape[0] // 2, 1)
            def half(a):
                return (a[:h] if torch.is_tensor(a) and a.dim() >= 1
                        and a.shape[0] == src.shape[0] else a)

            args = [half(a) for a in args]
            kwargs = {k: half(v) for k, v in kwargs.items()}
            return nce(model, src[:h], tgt[:h], *args, **kwargs)
        return [(engine, "recon_loss", recon_loss),
                (corr, "corr_info_nce", corr_info_nce)]
    if name == "altered_solve":
        from reart_tpu_torch.train import engine

        solve = engine._solve_assignment

        def shifted(*args, **kwargs):
            perm, price = solve(*args, **kwargs)
            return perm.roll(1, dims=-1), price
        return [(engine, "_solve_assignment", shifted)]
    if name == "altered_energy":
        from reart_tpu_torch import native

        lap = native.lap_solve_points

        def shifted_lap(*args, **kwargs):
            import numpy as np

            return np.roll(lap(*args, **kwargs), 1, axis=-1)
        return [(native, "lap_solve_points", shifted_lap)]
    if name == "altered_grouping":
        from reart_tpu_torch.models import pointnet2

        query = pointnet2.ball_query

        def shifted_query(radius, nsample, xyz, new_xyz):
            return (query(radius, nsample, xyz, new_xyz) + 1) % xyz.shape[1]
        return [(pointnet2, "ball_query", shifted_query)]
    raise ValueError(f"unknown fault {name!r}")


FAULTS = ("state_unchanged", "half_batch", "altered_solve", "altered_energy",
          "altered_grouping")


def plant(monkeypatch, name: str) -> None:
    for obj, attr, value in _patches(name):
        monkeypatch.setattr(obj, attr, value)


@contextlib.contextmanager
def planted(name: str):
    saved = []
    try:
        for obj, attr, value in _patches(name):
            saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, value)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
