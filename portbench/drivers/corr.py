"""The `corr` driver: training runs of the correspondence backbone through
`reart_tpu_torch.train.corr.train_corr`, back to back, a closed loop of one
caller who waits for each.

Set-up makes the sequence from the seed, normalised into the unit ball as
the command line normalises a robot sequence for `corr`, and warms up with
a short run. A unit is one training run of the traffic's `steps` steps at
the configuration's `corr` settings (CorrTrainConfig's defaults), from the
benchmark's own weights and random draws, made on the card from the seed.
`train_steps_per_s` is every step of every run over the window's
host-clock seconds, the closing run included.

The reference follows the first three steps of the window's first run
(the gradient of its first step and the weights after its third, read
where the optimizer hands them over; the losses as `train_corr` returns
them).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from drivers.fit import Capture, counter_delta, counters, sync
from yardstick import synth
from yardstick.seeds import derive

CORR_KEYS = ("batch", "n_points", "k_parts", "min_parts", "max_angle",
             "max_slide", "jitter", "global_angle", "global_slide",
             "scale_jitter", "temperature", "lr", "bn_momentum", "out_dim",
             "compute_dtype", "resample", "pos_radius", "neg_radius")
FAULTS = ("state_unchanged", "half_batch", "altered_grouping")


def make_backbone_weights(shapes: dict, seed: int, dev) -> dict:
    """Every conv + BN layer's weights, on the device from the seed in one
    draw: the conv's weight (out, in) and bias uniform in +-1/sqrt(in)
    (torch's Conv default), the BN scale 1 and shift 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    total = sum(o * i + o for i, o in shapes.values())
    u = torch.rand(total, generator=gen, device=dev) * 2 - 1
    out, at = {}, 0
    for name, (c_in, c_out) in shapes.items():
        bound = 1.0 / np.sqrt(c_in)
        w = u[at:at + c_out * c_in].reshape(c_out, c_in) * bound
        at += c_out * c_in
        b = u[at:at + c_out] * bound
        at += c_out
        out.update({f"{name}.weight": w, f"{name}.bias": b,
                    f"{name}.bn_weight": torch.ones(c_out, device=dev),
                    f"{name}.bn_bias": torch.zeros(c_out, device=dev)})
    return out


def make_draws(gen: torch.Generator, f_count: int, n0: int, c: dict) -> dict:
    """One step's random draws, in the program's `draw_pairs` form: the
    frame, the point permutation, the Voronoi seeds and part count, each
    part's axis, angle and slide, the global motion, the jitter and the
    rescale."""
    b, n, k = c["batch"], c["n_points"], c["k_parts"]
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(half, *shape):
        return (2.0 * torch.rand(shape, generator=gen, device=dev) - 1.0) \
            * half

    def perms(m):
        return torch.argsort(torch.rand((b, m), generator=gen, device=dev),
                             dim=-1)

    return {
        "frame": torch.randint(0, f_count, (b,), generator=gen, device=dev),
        "perm": perms(n0), "seed_perm": perms(n),
        "k_active": torch.randint(c["min_parts"], k + 1, (b,), generator=gen,
                                  device=dev),
        "axis": normal(b, k, 3), "angle": uniform(c["max_angle"], b, k, 1),
        "slide": normal(b, k, 3), "gaxis": normal(b, 3),
        "gangle": uniform(c["global_angle"], b), "gslide": normal(b, 3),
        "jitter_src": normal(b, n, 3), "jitter_tgt": normal(b, n, 3),
        "scale": 1.0 + uniform(c["scale_jitter"], b)}


class CorrDriver:
    def __init__(self, cell, seed: int, dev: torch.device):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.cfg, self.traffic = cell.config, cell.traffic
        self.corr = cell.config["corr"]

    def setup(self) -> dict:
        from reference.corr import layer_shapes

        t0 = time.perf_counter()
        c = self.cfg
        sample = synth.robot_sample(c["n_frames"], c["num_points"],
                                    c["data"]["n_parts"],
                                    derive(self.seed, "sequence", 0))
        pcs = sample["complete_pc_list"]
        flat = pcs.reshape(-1, 3)
        centroid = flat.mean(0).astype(np.float32)
        scale = np.float32(1.0 / max(
            float(np.linalg.norm(flat - centroid, axis=-1).max()), 1e-6))
        self.frames = torch.as_tensor((pcs - centroid) * scale,
                                      device=self.dev)
        self.shapes = layer_shapes(self.corr["out_dim"])
        sync(self.dev)
        t1 = time.perf_counter()
        self.run_unit(0, self.traffic["warmup_steps"], tag="warmup")
        sync(self.dev)
        return {"inputs": t1 - t0, "warm-up run": time.perf_counter() - t1}

    def train_cfg(self, steps: int):
        from reart_tpu_torch.train.corr import CorrTrainConfig

        return CorrTrainConfig(steps=steps,
                               **{k: self.corr[k] for k in CORR_KEYS})

    def run_unit(self, k: int, steps: int, tag: str = "window",
                 capture: Capture | None = None):
        from reart_tpu_torch.models.pointnet2 import PointNet2Msg2
        from reart_tpu_torch.train.corr import train_corr

        dev = self.dev
        weights = make_backbone_weights(
            self.shapes, derive(self.seed, tag, "weights", k), dev)
        model = PointNet2Msg2(self.corr["out_dim"], device=dev)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name])
        gen = torch.Generator(device=dev).manual_seed(
            derive(self.seed, tag, "draws", k))
        f_count, n0 = self.frames.shape[:2]
        keep = [] if capture is not None else None

        def draws(step):
            d = make_draws(gen, f_count, n0, self.corr)
            if keep is not None and step < 3:
                keep.append({key: v.clone() for key, v in d.items()})
            return d

        handle = None
        if capture is not None:
            capture.bind(model)
            handle = register_optimizer_step_post_hook(capture.hook)
        try:
            _, losses = train_corr(derive(self.seed, tag, "train", k),
                                   self.frames, self.train_cfg(steps),
                                   model=model, draws=draws, device=dev)
        finally:
            if handle is not None:
                handle.remove()
        if capture is not None:
            self.first = {"weights": weights, "draws": keep,
                          "losses": [float(x) for x in losses[:3]]}

    def window(self, seconds: float) -> dict:
        steps = self.corr["steps"]
        cap = Capture(weights_at={3}, grads_at={1}, state_at=(),
                      names=None)
        c0 = counters()
        t0 = time.perf_counter()
        units, ends = 0, []
        while True:
            self.run_unit(units, steps, capture=cap if units == 0 else None)
            units += 1
            sync(self.dev)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        dt = time.perf_counter() - t0
        self.capture = cap
        return {"seconds": dt, "units": units, "ends": ends, "steps": units * steps,
                "launches": counter_delta(c0, counters()),
                "end_to_end": {"train_steps_per_s": units * steps / dt}}

    def traced_work(self):
        """A short training run of the window's kind (traffic
        `trace_steps`)."""
        state = {}

        def work():
            self.run_unit(0, self.traffic["trace_steps"], tag="trace")
            sync(self.dev)
            state["steps"] = self.traffic["trace_steps"]
        return work, state

    def check_numbers(self) -> dict:
        from reference import corr as ref
        from yardstick.compare import stage_numbers

        first, cap = self.first, self.capture
        out = ref.follow(dict(first["weights"]), self.frames, first["draws"],
                         {**self.corr})
        detail = {}
        nums = stage_numbers(first["losses"], out["losses"], cap.grads[1],
                             out["grad0"], first["weights"], cap.weights[3],
                             out["weights"], detail)
        print(f"check detail: start {detail}", file=sys.stderr)
        return {f"start.{k}": v for k, v in nums.items()}

    def close(self) -> None:
        """Nothing of a training run outlives the process."""


def driver(cell, seed, dev):
    return CorrDriver(cell, seed, dev)
