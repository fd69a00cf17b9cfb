"""The `sequence` driver: whole relaxation runs through
`reart_tpu_torch.cli.run_sample`, one sequence after another, a closed loop
of one caller who waits for each.

A unit is what the command line does after loading a sequence: the flow
anchors (`setup_flow`, GT flow here), the model, the fit, the final forward
and `finalize` (segmentation refinement, graph stage, metrics, retargeting,
TED, the selection energy with its exact host LAP, result files, and the
gif and html artifacts), with the traffic's `args` and its fit length.
Each run starts from the benchmark's own weights, handed to the program as
the reference's torch-format BaseModel checkpoint (`--resume`), and its
Gumbel draws; its results go to a directory under TMPDIR that is deleted
after the sequence. `seq_s` is the window's host-clock seconds over the
sequences completed in it, the closing one included.

The first sequence of the window is the one the reference follows: the
fit's stages as in the `fit` driver (the history read off `fit_base` as it
returns), and the selection energy's assignment and group terms, worked
out again from the inputs and the run's final segmentation and poses
(result.pkl).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from drivers.fit import FAULTS as FIT_FAULTS
from drivers.fit import (
    FIT_KEYS,
    Capture,
    FitDriver,
    counter_delta,
    counters,
    gumbel,
    make_weights,
    sync,
)
from yardstick import synth
from yardstick.seeds import derive

FAULTS = FIT_FAULTS + ("altered_energy",)


def write_reference_checkpoint(path: str, w: dict) -> None:
    """The benchmark's weights as the reference's `torch.save` BaseModel
    checkpoint (its seg head Conv1d weights (C_out, C_in, 1))."""
    sd = {"proposal_6d": w["p6d"].cpu(), "proposal_t": w["pt"].cpu(),
          "seg_head.model.0.weight": w["w0"].cpu()[:, :, None],
          "seg_head.model.0.bias": w["b0"].cpu(),
          "seg_head.model.2.weight": w["w1"].cpu()[:, :, None]}
    torch.save({"state_dict": sd, "tau": 1.0, "cano_idx": 0}, path)


class SequenceDriver(FitDriver):
    def setup(self) -> dict:
        from reart_tpu_torch import cli
        from reart_tpu_torch.train import FitConfig

        cfg = self.cfg
        t0 = time.perf_counter()
        self.tmp = tempfile.mkdtemp(prefix="portbench_sequence_")
        self.pool = [synth.robot_sample(cfg["n_frames"], cfg["num_points"],
                                        cfg["data"]["n_parts"],
                                        derive(self.seed, "sequence", i))
                     for i in range(self.traffic["pool"])]
        self.fit_cfg = FitConfig(**{k: self.run_cfg[k] for k in FIT_KEYS})
        self.parser = cli.build_parser()
        t1 = time.perf_counter()
        self.run_unit(0, tag="warmup")
        sync(self.dev)
        return {"inputs": t1 - t0, "warm-up sequence": time.perf_counter() - t1}

    def args(self, ckpt: str, save_root: str):
        c, f = self.cfg, self.fit_cfg
        argv = [c["domain"], "--silence", "--resume", ckpt,
                "--save_root", save_root, "--num_parts", str(c["num_parts"]),
                "--num_points", str(c["num_points"]),
                "--n_iter", str(f.n_iter), "--assign_iter", str(f.assign_iter),
                "--flow_provider", c["flow_provider"]]
        for key in ("assign_gap", "downsample", "lambda_assign",
                    "lambda_flow", "start_tau", "end_tau", "seg_lr",
                    "trans_lr", "assign_sweeps", "assign_band",
                    "assign_band_guard", "assign_band_reprobe"):
            argv += [f"--{key}", str(c[key])]
        argv += ["--use_flow_loss"] * c["use_flow_loss"]
        argv += ["--use_assign_loss"] * c["use_assign_loss"]
        argv += list(self.traffic["args"])
        return self.parser.parse_args(argv)

    def run_unit(self, k: int, tag: str = "window",
                 capture: Capture | None = None) -> dict:
        import reart_tpu_torch.train as train
        from reart_tpu_torch import cli

        dev, cfg = self.dev, self.cfg
        sample = self.pool[k % len(self.pool)]
        unit_dir = os.path.join(self.tmp, f"{tag}_{k}")
        os.makedirs(unit_dir)
        weights = make_weights(cfg, derive(self.seed, tag, "weights", k), dev)
        ckpt = os.path.join(unit_dir, "start.pt")
        write_reference_checkpoint(ckpt, weights)
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

        save_dir = os.path.join(unit_dir, "run")
        handle, fit_base, hist = None, train.fit_base, {}
        if capture is not None:
            def recorded(params, *a, **kw):
                capture.bind(params)
                out = fit_base(params, *a, **kw)
                hist["total_loss"] = out[1]["total_loss"]
                return out

            train.fit_base = recorded
            handle = register_optimizer_step_post_hook(capture.hook)
        try:
            results = cli.run_sample(self.args(ckpt, unit_dir), cfg["domain"],
                                     sample, save_dir, device=dev,
                                     noise=noise)
        finally:
            train.fit_base = fit_base
            if handle is not None:
                handle.remove()
        if capture is not None:
            with open(os.path.join(save_dir, "result.pkl"), "rb") as f:
                res = pickle.load(f)
            self.first_weights, self.draws = weights, keep
            self.hist = hist["total_loss"]
            self.first_inputs = _fit_inputs(sample, dev)
            self.first_result = {
                "results": dict(results),
                "seg": res["pred_cano_part"], "poses": res["pred_pose_list"],
                "sample": sample}
        shutil.rmtree(unit_dir)
        return results

    def window(self, seconds: float) -> dict:
        from reart_tpu_torch.profiling import phase_report, reset_phases

        cap = self.new_capture()
        c0 = counters()
        reset_phases()
        t0 = time.perf_counter()
        units, ends = 0, []
        while True:
            self.run_unit(units, capture=cap if units == 0 else None)
            units += 1
            sync(self.dev)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        dt = time.perf_counter() - t0
        self.capture = cap
        return {"seconds": dt, "units": units, "ends": ends,
                "iterations": units * self.fit_cfg.n_iter,
                "launches": counter_delta(c0, counters()),
                "phases": phase_report(),
                "end_to_end": {"seq_s": dt / units}}

    def traced_work(self):
        """One sequence of the window's kind."""
        state = {}

        def work():
            c0 = counters()
            self.run_unit(0, tag="trace")
            sync(self.dev)
            state["launches"] = counter_delta(c0, counters())
            state["units"] = 1
        return work, state

    def check_numbers(self) -> dict:
        from reference import energy as ref_energy

        numbers = super().check_numbers()
        fr = self.first_result
        ref = ref_energy.selection_energy(
            fr["sample"]["cano_pc"], fr["sample"]["pc_list"], fr["seg"],
            fr["poses"], self.dev, workers=self.traffic["check_workers"])
        for term in ("ass_err", "group_err"):
            prog = float(fr["results"][term])
            numbers[f"energy.{term}"] = abs(prog - ref[term]) / max(
                abs(ref[term]), 1e-30)
        return numbers

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def _fit_inputs(sample: dict, dev) -> dict:
    """The fit's inputs of a robot sample with GT flow, as the reference
    takes them."""
    gt = sample["complete_gt_pc_list"]
    raw = {"cano": sample["cano_pc"], "frames": sample["pc_list"],
           "anchors": gt[:-1], "flows": gt[1:] - gt[:-1]}
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in raw.items()}


def driver(cell, seed, dev):
    return SequenceDriver(cell, seed, dev)
