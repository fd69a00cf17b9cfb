"""The `fit` driver: whole relaxation fits back to back, a closed loop of
one caller who waits for each fit.

Set-up makes a pool of sequences from the seed (the configuration's `data`
block), their flow anchors, and warms up with one short fit that crosses
both phases on the cell's own shapes. The window then runs fits of the
configuration's settings through `reart_tpu_torch.train.engine.fit_base`,
each from fresh weights and Gumbel draws made from the seed, cycling over
the pool, and closes at the end of the fit in progress when the window's
seconds run out. `fit_iters_per_s` is every iteration of every fit over
the window's host-clock seconds, the closing fit included.

The first fit of the window is the one the reference follows, three steps
at each of four stages (`FitDriver.stages`): an optimizer step hook
records its first gradient, weights and Adam state at the start of each
stage, the weights three steps later, and the draws it was given (program
state read where the optimizer hands it over; the fit's own code is not
touched).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from yardstick import synth
from yardstick.seeds import derive

# the program's parameter names -> the reference's leaf names
PROGRAM_LEAVES = {"seg.layers.0.weight": "w0", "seg.layers.0.bias": "b0",
                  "seg.layers.1.weight": "w1", "proposal_6d": "p6d",
                  "proposal_t": "pt"}
FIT_KEYS = ("n_iter", "use_assign_loss", "use_flow_loss", "always_recon",
            "assign_iter", "assign_gap", "downsample", "lambda_assign",
            "lambda_flow", "start_tau", "end_tau", "seg_lr", "trans_lr",
            "assign_sweeps", "assign_band", "assign_band_guard",
            "assign_band_reprobe")
# the faults of faults.py a fit cell can have
FAULTS = ("state_unchanged", "half_batch", "altered_solve")
# the launch counters the metrics read, by wrapper
COUNTERS = {
    "nn1_bidir_coords": ("ops.cuda_nn", "nn1_bidir_coords"),
    "blend3": ("ops.cuda_nn", "blend3"),
    "fps": ("ops.cuda_fps", "fps"),
    "auction_solve_resident": ("ops.cuda_auction", "auction_solve_resident"),
    "auction_solve_resident_hbm": ("ops.cuda_auction",
                                   "auction_solve_resident_hbm"),
    "auction_solve_large": ("ops.cuda_auction", "auction_solve_large"),
    "auction_solve_banded": ("ops.cuda_auction", "auction_solve_banded"),
}


def counters() -> dict:
    import importlib

    out = {}
    for key, (mod, fn) in COUNTERS.items():
        m = importlib.import_module(f"reart_tpu_torch.{mod}")
        out[key] = int(getattr(getattr(m, fn), "launches", 0))
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gumbel(gen: torch.Generator, shape, dev) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=dev)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def make_weights(cfg: dict, seed: int, dev) -> dict:
    """The relaxation model's starting weights, on the device from the
    seed: the seg MLP uniform in +-1/sqrt(fan in) (torch's Linear
    default), the proposals the identity (6d (1, 0, 0, 0, 1, 0), zero
    translation) plus normal noise of `start_noise` (the configuration's).

    The noise keeps the start off a knife-edge that two correct
    implementations decide by rounding: at the identity every predicted
    point sits on the canonical cloud, so a part that moves 0.05 a frame
    (the table's drawer) puts the flow mask's nearest-anchor distance on
    its 0.05 threshold."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, p, t = cfg["hidden"], cfg["num_parts"], cfg["n_frames"] - 1

    def uniform(shape, fan_in):
        b = 1.0 / np.sqrt(fan_in)
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * b

    def normal(shape):
        return cfg["start_noise"] * torch.randn(shape, generator=gen,
                                                device=dev)

    ident = torch.tensor([1.0, 0, 0, 0, 1.0, 0], device=dev)
    return {"w0": uniform((h, 3), 3), "b0": uniform((h,), 3),
            "w1": uniform((p, h), h),
            "p6d": ident.repeat(t, p, 1) + normal((t, p, 6)),
            "pt": normal((t, p, 3))}


class Capture:
    """What the reference needs of one fit, recorded by a global optimizer
    step hook: at step count c in `weights_at` the weights after that step
    (with Adam's state at the counts in `state_at`), at counts in
    `grads_at` the gradient the step took."""

    def __init__(self, weights_at, grads_at, state_at,
                 names: dict | None = PROGRAM_LEAVES):
        self.weights_at, self.grads_at = set(weights_at), set(grads_at)
        self.state_at = set(state_at)
        self.names = names      # program parameter name -> leaf (None: same)
        self.leaf, self.count = {}, 0
        self.weights, self.grads, self.states = {}, {}, {}

    def bind(self, model) -> None:
        """Record the steps of `model`'s training from its first."""
        self.leaf = {id(p): n if self.names is None else self.names[n]
                     for n, p in model.named_parameters()}
        self.count = 0

    def hook(self, opt, _args, _kwargs):
        self.count += 1
        c = self.count
        if c not in self.weights_at | self.grads_at:
            return
        params = [p for g in opt.param_groups for p in g["params"]]
        if c in self.grads_at:
            self.grads[c] = {self.leaf[id(p)]: p.grad.detach().clone()
                             for p in params}
        if c in self.weights_at:
            self.weights[c] = {self.leaf[id(p)]: p.detach().clone()
                               for p in params}
        if c in self.state_at:
            # a parameter the optimizer never stepped has no state yet
            self.states[c] = {
                self.leaf[id(p)]: {
                    "m": opt.state[p]["exp_avg"].detach().clone(),
                    "v": opt.state[p]["exp_avg_sq"].detach().clone(),
                    "step": int(opt.state[p]["step"])}
                for p in params if "exp_avg" in opt.state[p]}


class FitDriver:
    def __init__(self, cell, seed: int, dev: torch.device):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.cfg = cell.config
        self.traffic = cell.traffic
        # the configuration with the traffic's own fit length, as run
        self.run_cfg = {**cell.config, **cell.traffic.get("fit", {})}
        self.capture = self.draws = self.hist = None
        self.first_weights = None

    # -- set-up ---------------------------------------------------------
    def setup(self) -> dict:
        """-> {stage: seconds} of the set-up."""
        from reart_tpu_torch.train import FitConfig, FlowContext

        dev, cfg = self.dev, self.cfg
        t0 = time.perf_counter()
        self.pool = []
        for i in range(self.traffic["pool"]):
            raw = synth.fit_inputs(cfg, derive(self.seed, "sequence", i))
            inputs = {k: torch.as_tensor(v, device=dev)
                      for k, v in raw.items()}
            inputs["flow_ctx"] = FlowContext(inputs["anchors"],
                                             inputs["flows"])
            self.pool.append(inputs)
        self.fit_cfg = FitConfig(**{k: self.run_cfg[k] for k in FIT_KEYS})
        sync(dev)
        t1 = time.perf_counter()
        warm = self.traffic["warmup_fit"]
        self.run_fit(0, FitConfig(**{**{k: cfg[k] for k in FIT_KEYS},
                                     **warm}), tag="warmup")
        sync(dev)
        return {"inputs": t1 - t0, "warm-up fit": time.perf_counter() - t1}

    def run_fit(self, k: int, fit_cfg, tag: str = "window",
                capture: Capture | None = None):
        from reart_tpu_torch.models.base_model import BaseModel
        from reart_tpu_torch.train import fit_base

        dev, cfg = self.dev, self.cfg
        inputs = self.pool[k % len(self.pool)]
        weights = make_weights(cfg, derive(self.seed, tag, "weights", k), dev)
        model = BaseModel(cfg["num_parts"], cfg["n_frames"] - 1,
                          cfg["hidden"], device=dev)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[PROGRAM_LEAVES[name]])
        gen = torch.Generator(device=dev).manual_seed(
            derive(self.seed, tag, "gumbel", k))
        shape = (cfg["num_points"], cfg["num_parts"])
        keep = {} if capture is not None else None
        wanted = self.draw_iters()

        def noise(it):
            g = gumbel(gen, shape, dev)
            if keep is not None and it in wanted:
                keep[it] = g.clone()
            return g

        handle = None
        if capture is not None:
            capture.bind(model)
            handle = register_optimizer_step_post_hook(capture.hook)
        try:
            _, hist = fit_base(model, fit_cfg, inputs["cano"],
                               inputs["frames"], flow_ctx=inputs["flow_ctx"],
                               noise=noise, device=dev)
        finally:
            if handle is not None:
                handle.remove()
        if capture is not None:
            self.first_weights, self.draws = weights, keep
            self.hist = hist["total_loss"]
            self.first_inputs = inputs
        return hist

    def stages(self) -> dict:
        """The stages the reference follows, three steps each: {name:
        (first iteration, assignment phase)}. The fit's first steps, from
        the benchmark's own weights; the middle of the recon phase; the
        assignment phase's first steps (its first solve, cold); and a LAP
        boundary half way through that phase (a warm solve). All but the
        first start from the program's weights and Adam state there, so
        each stage also checks the state the steps before it left."""
        c = self.fit_cfg
        assign = c.use_assign_loss and c.assign_iter + 3 <= c.n_iter
        recon_end = c.assign_iter if assign else c.n_iter
        out = {"start": (0, False)}
        if 3 <= recon_end // 2 and recon_end // 2 + 3 <= recon_end:
            out["recon_mid"] = (recon_end // 2, False)
        if assign:
            out["assign"] = (c.assign_iter, True)
            gap = max(c.assign_gap, 1)
            late = c.assign_iter + gap * ((c.n_iter - c.assign_iter)
                                          // (2 * gap))
            if late > c.assign_iter and late + 3 <= c.n_iter:
                out["assign_mid"] = (late, True)
        return out

    def draw_iters(self) -> set:
        return {i + j for i, _ in self.stages().values() for j in range(3)}

    # -- the window -----------------------------------------------------
    def new_capture(self) -> Capture:
        """A capture of the stages the reference follows: the weights (and
        Adam's state) before each stage but the start, whose weights are the
        benchmark's, its first gradient, and the weights three steps on."""
        first = {i for i, _ in self.stages().values()}
        return Capture(weights_at={i for i in first if i}
                       | {i + 3 for i in first},
                       grads_at={i + 1 for i in first},
                       state_at={i for i in first if i})

    def window(self, seconds: float) -> dict:
        dev = self.dev
        cap = self.new_capture()
        c0 = counters()
        t0 = time.perf_counter()
        fits, ends = 0, []
        while True:
            self.run_fit(fits, self.fit_cfg,
                         capture=cap if fits == 0 else None)
            fits += 1
            sync(dev)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        dt = time.perf_counter() - t0
        self.capture = cap
        iters = fits * self.fit_cfg.n_iter
        return {"seconds": dt, "units": fits, "ends": ends, "iterations": iters,
                "launches": counter_delta(c0, counters()),
                "end_to_end": {"fit_iters_per_s": iters / dt}}

    # -- the traced segment ---------------------------------------------
    def traced_work(self):
        """One short fit of the cell's shapes, both phases in the
        configuration's ratio (traffic `trace_fit`)."""
        from reart_tpu_torch.train import FitConfig

        fit_cfg = FitConfig(**{**{k: self.cfg[k] for k in FIT_KEYS},
                               **self.traffic["trace_fit"]})
        state = {}

        def work():
            c0 = counters()
            self.run_fit(0, fit_cfg, tag="trace")
            sync(self.dev)
            state["launches"] = counter_delta(c0, counters())
            state["iterations"] = fit_cfg.n_iter
        return work, state

    # -- the reference --------------------------------------------------
    def check_numbers(self) -> dict:
        from reference import fit as ref
        from yardstick.compare import stage_numbers

        cap, cfg = self.capture, self.run_cfg
        inputs = {k: self.first_inputs[k]
                  for k in ("cano", "frames", "anchors", "flows")}
        hist = self.hist.detach().cpu().tolist()
        numbers = {}
        for name, (first, assign) in self.stages().items():
            if first == 0:
                before, state = self.first_weights, {}
            else:
                before, state = cap.weights[first], cap.states[first]
            out = ref.follow(dict(before), state, cfg, inputs,
                             [self.draws[first + j] for j in range(3)],
                             first, assign,
                             self.traffic.get("check_workers", 1))
            detail = {}
            nums = stage_numbers(hist[first:first + 3], out["losses"],
                                 cap.grads[first + 1], out["grad0"], before,
                                 cap.weights[first + 3], out["weights"],
                                 detail)
            print(f"check detail: {name} {detail}", file=sys.stderr)
            numbers.update({f"{name}.{k}": v for k, v in nums.items()})
        return numbers


    def close(self) -> None:
        """Nothing of a fit outlives the process."""


def driver(cell, seed, dev):
    return FitDriver(cell, seed, dev)
