"""Port parity: the corr chain of the command line (`corr`, then `robot`
with the default --flow_provider corr) on the toy robot directory, on the
CPU, against the JAX package's setup_flow on the same checkpoint."""

import os
import pickle

import numpy as np
import torch

from reart_tpu import cli as jax_cli
from reart_tpu_torch import cli
from reart_tpu_torch.models import pointnet2 as tpn

torch.set_num_threads(1)


def _norm_file(tmp_path, robot_dir):
    cat = os.path.basename(robot_dir.rstrip("/"))
    path = str(tmp_path / "normalize.pkl")
    with open(path, "wb") as f:
        pickle.dump({cat: {"centroid": np.zeros(3, np.float32),
                           "scale": 1.0}}, f)
    return path, cat


def test_corr_chain_on_the_toy_robot(robot_dir, tmp_path):
    """The slice as a whole on the CPU: `corr` trains a backbone on the toy
    sequence for a few steps, then `robot --model base` with the default
    --flow_provider fits from its SMNN anchors and reaches result.txt; and
    both packages' setup_flow give equal anchors from that file."""
    norm_path, cat = _norm_file(tmp_path, robot_dir)
    ckpt_path = str(tmp_path / "corr_model.pkl")
    torch_path = str(tmp_path / "corr_model.pth.tar")
    out = cli.main([
        "corr", "--device", "cpu", "--data_domain", "robot", "--seq_path",
        robot_dir, "--normalize_file", norm_path, "--num_points", "360",
        "--steps", "1", "--batch", "2", "--train_points", "128",
        "--dispatch_chunk", "2", "--save_path", ckpt_path, "--save_torch",
        torch_path])
    assert os.path.exists(ckpt_path) and os.path.exists(torch_path)
    assert np.isfinite(out["loss"]) and np.isfinite(out["first_loss"])
    assert 0.0 <= out["precision"] <= 1.0 and 0.0 <= out["match_rate"] <= 1.0
    assert 0.0 < out["real_match_rate"] <= 1.0

    common = ["robot", "--seq_path", robot_dir, "--num_points", "360",
              "--use_flow_loss", "--corr_model_path", ckpt_path,
              "--normalize_file", norm_path, "--num_parts", "4"]
    targs = cli.build_parser().parse_args(common + ["--device", "cpu"])
    jargs = jax_cli.build_parser().parse_args(common)
    assert targs.flow_provider == jargs.flow_provider == "corr"
    for name in ("match_th", "match_refine_k", "match_disp_gate",
                 "match_chain_r", "corr_model_path", "normalize_file"):
        assert getattr(targs, name) == getattr(jargs, name), name
    dataset = jax_cli.load_dataset(jargs, "robot")
    sample = dataset[0]
    ref = jax_cli.setup_flow(jargs, "robot", dataset, sample)
    got = cli.setup_flow(targs, sample, "cpu")
    # anchors as sets of (point, flow) rows: an anchor is a point of the
    # cloud and its flow a difference of two points, so a match made by both
    # packages gives the same row exactly. A ratio test within 1e-4 of its
    # threshold can fall either way (the features agree to rtol 1e-4): at
    # most 1 anchor in 100 may be in one set only.
    for t in range(3):
        def rows(ctx):
            both = np.concatenate([np.asarray(ctx.pc_ref[t]),
                                   np.asarray(ctx.flow_ref[t])], axis=1)
            return {tuple(r) for r in both.tolist() if r[0] < 1e5}

        a, b = rows(got), rows(ref)
        assert len(a) > 100 and len(a ^ b) <= 0.01 * len(a), (len(a), len(b),
                                                              len(a ^ b))
    # the torch-format file holds the same backbone
    a = tpn.load_corr_model(ckpt_path, device="cpu").state_dict()
    b = tpn.load_corr_model(torch_path, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)

    save_root = str(tmp_path / "exp")
    cli.main(common + [
        "--device", "cpu", "--save_root", save_root, "--n_iter", "40",
        "--assign_iter", "1000", "--start_tau", "1", "--end_tau", "0.5",
        "--snapshot_gap", "1000", "--silence"])
    txt = open(os.path.join(save_root, cat, "result.txt")).read()
    assert "flow_epe" in txt and "seg_ri" in txt
