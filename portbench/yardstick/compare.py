"""The comparison that decides `correct` for a training-like cell.

Each stage the reference follows (three steps) gives three numbers, each
the worst over its parts, each to be at or under its limit:

  loss    max over the steps of |loss_prog - loss_ref| / |loss_ref|
  grad    max over leaves of |norm(g_prog) - norm(g_ref)| /
          max(norm(g_ref), the median leaf's norm(g_ref)), the stage's
          first gradient as the optimizer got it
  change  the same of the weights' change over the stage's steps, over
          the leaves whose reference gradient is at least a thousandth of
          the median leaf's (one that is nought to rounding moves under
          Adam by round-off alone)

A number that is not finite reads inf, and so fails.
"""

from __future__ import annotations

import math
import statistics

import torch


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in tree.items()}


def _worst(prog: dict, ref: dict, keys) -> tuple[float, str]:
    """(the largest gap, its leaf)."""
    keys = list(keys)
    if not keys:
        return 0.0, ""
    floor = statistics.median(ref[k] for k in keys)
    out, which = 0.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
        gap = gap if math.isfinite(gap) else math.inf
        if gap > out or not which:
            out, which = gap, k
    return out, which


def stage_numbers(prog_losses, ref_losses, prog_grad0: dict, ref_grad0: dict,
                  w_before: dict, prog_after: dict, ref_after: dict,
                  detail: dict | None = None) -> dict:
    """{loss, grad, change} of one stage; trees keyed by the reference's
    leaf names. `detail` gains each step's two losses, the leaves that read
    worst and the leaves left out of the change."""
    loss = 0.0
    for a, b in zip(prog_losses, ref_losses):
        gap = abs(a - b) / max(abs(b), 1e-30)
        loss = max(loss, gap if math.isfinite(gap) else math.inf)
    gp, gr = _norms(prog_grad0), _norms(ref_grad0)
    floor = statistics.median(gr.values())
    moving = [k for k in gr if gr[k] >= 1e-3 * floor]
    dp = _norms({k: prog_after[k] - w_before[k] for k in moving})
    dr = _norms({k: ref_after[k] - w_before[k] for k in moving})
    grad, grad_leaf = _worst(gp, gr, gr)
    change, change_leaf = _worst(dp, dr, moving)
    if detail is not None:
        detail.update(losses=[[a, b] for a, b in zip(prog_losses,
                                                     ref_losses)],
                      grad_leaf=grad_leaf, change_leaf=change_leaf,
                      left_out=sorted(set(gr) - set(moving)))
    return {"loss": loss, "grad": grad, "change": change}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over every limited number; a
    number without a limit, or a limit without its number, fails."""
    checks, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name, math.inf), limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks
