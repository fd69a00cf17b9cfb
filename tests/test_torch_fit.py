"""Port parity for the slice as a whole: a toy relaxation fit (recon+flow
phase, then assign+flow phase) in both packages from the same parameters,
clouds and Gumbel draws, plus the port's import hygiene.

The proposals start from a seeded perturbation of the identity: at the
identity init the exact seg-MLP gradient of the first step is zero, and
Adam's normalisation turns each package's rounding noise there into
opposite +-lr updates (see ROADMAP.md, faults found in the port)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu.models.base_model import init_base_params
from reart_tpu.train import FitConfig as JaxFitConfig
from reart_tpu.train import FlowContext as JaxFlowContext
from reart_tpu.train import build_assign_context as jax_build_assign_context
from reart_tpu.train import fit_base as jax_fit_base
from reart_tpu_torch.interop import base_params_from_jax
from reart_tpu_torch.train import (
    FitConfig,
    FlowContext,
    build_assign_context,
    fit_base,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, P = 256, 4, 3
FIT = dict(n_iter=12, assign_iter=6, assign_gap=3, downsample=2,
           use_flow_loss=True, use_assign_loss=True)


def _sequence():
    rng = np.random.RandomState(0)
    cano = rng.randn(N, 3).astype(np.float32)
    pcs = np.stack([cano + 0.02 * i for i in range(1, T)])
    complete = np.concatenate([cano[None], pcs], 0)
    anchors = [complete[i] for i in range(T - 1)]
    flows = [complete[i + 1] - complete[i] for i in range(T - 1)]
    return cano, pcs, anchors, flows


@pytest.fixture(scope="module")
def histories():
    cano, pcs, anchors, flows = _sequence()
    key = jax.random.PRNGKey(0)
    params = init_base_params(key, num_parts=P, pose_len=T - 1)
    rng = np.random.RandomState(1)
    params["proposal_6d"] = params["proposal_6d"] + jnp.asarray(
        0.1 * rng.randn(T - 1, P, 6).astype(np.float32))
    params["proposal_t"] = jnp.asarray(
        0.1 * rng.randn(T - 1, P, 3).astype(np.float32))
    _, jax_hist = jax_fit_base(
        key, params, JaxFitConfig(dispatch_chunk=FIT["n_iter"], **FIT), cano,
        pcs, flow_ctx=JaxFlowContext.from_lists(anchors, flows))

    def noise(it):  # JAX's own draw of iteration `it`
        return np.asarray(jax.random.gumbel(jax.random.fold_in(key, it),
                                            (N, P), jnp.float32))

    model = base_params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    _, hist = fit_base(model, FitConfig(**FIT), cano, pcs,
                       flow_ctx=FlowContext.from_lists(anchors, flows),
                       noise=noise, device="cpu")
    return ({k: np.asarray(v) for k, v in jax_hist.items()},
            {k: v.numpy() for k, v in hist.items()})


@pytest.mark.parametrize("name", ["total_loss", "recon_loss", "ass_loss",
                                  "flow_loss"])
def test_fit_history_matches_jax(histories, name):
    ref, got = histories[0][name], histories[1][name]
    assert got.shape == ref.shape == (FIT["n_iter"],)
    # rtol 1e-3: 12 Adam steps amplify 1-ulp differences between XLA:CPU
    # and ATen reductions
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-7)


def test_history_terms_are_phase_exact(histories):
    got = histories[1]
    n_recon = FIT["assign_iter"]
    assert (got["recon_loss"][:n_recon] > 0).all()
    assert (got["recon_loss"][n_recon:] == 0).all()
    assert (got["ass_loss"][:n_recon] == 0).all()
    assert (got["ass_loss"][n_recon:] > 0).all()
    assert (got["flow_loss"] > 0).all()


def test_flow_context_padding_matches_jax():
    rng = np.random.RandomState(2)
    pcs = [rng.randn(n, 3).astype(np.float32) for n in (5, 9, 7)]
    flows = [rng.randn(n, 3).astype(np.float32) for n in (5, 9, 7)]
    ref = JaxFlowContext.from_lists(pcs, flows)
    got = FlowContext.from_lists(pcs, flows)
    np.testing.assert_array_equal(got.pc_ref.numpy(), np.asarray(ref.pc_ref))
    np.testing.assert_array_equal(got.flow_ref.numpy(),
                                  np.asarray(ref.flow_ref))


def test_assign_context_matches_jax():
    cano, pcs, _, _ = _sequence()
    ref = jax_build_assign_context(jnp.asarray(cano), jnp.asarray(pcs), 2)
    got = build_assign_context(torch.from_numpy(cano), torch.from_numpy(pcs),
                               2)
    np.testing.assert_array_equal(got.src_idx.numpy(),
                                  np.asarray(ref.src_idx))
    np.testing.assert_array_equal(got.pc_tgt.numpy(), np.asarray(ref.pc_tgt))


def test_port_imports_no_jax():
    code = ("import sys, reart_tpu_torch, reart_tpu_torch.train, "
            "reart_tpu_torch.interop, reart_tpu_torch.ops.cuda_nn, "
            "reart_tpu_torch.ops.cuda_fps, reart_tpu_torch.ops.cuda_auction, "
            "reart_tpu_torch.cli, reart_tpu_torch.metrics, "
            "reart_tpu_torch.graph, reart_tpu_torch.checkpoint, "
            "reart_tpu_torch.data.robot, reart_tpu_torch.data.synth; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'networkx' not in sys.modules, 'networkx imported'; "
            "assert 'reart_tpu' not in sys.modules, 'reart_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    root = os.path.join(REPO, "reart_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith(("import jax", "from jax",
                                                 "import reart_tpu ",
                                                 "from reart_tpu ",
                                                 "from reart_tpu.",
                                                 "import reart_tpu.")), \
                            f"{f}: {s}"
