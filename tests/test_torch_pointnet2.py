"""Port parity: the PointNet++ MSG backbone (reart_tpu_torch.models.pointnet2)
against reart_tpu.models.pointnet2 on the same weights and clouds, the
weights carried by interop.pointnet2_params_from_jax.

The clouds lie on a 1/64 grid: the JAX package's ball query and 3-NN take
the cross-term distance and the port the diff^2 form, and on such
coordinates both are exact, with no squared distance within 5e-5 of a
squared radius, so both packages group the same points. One size (B = 2,
N = 600) serves every test."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu.models import pointnet2 as jpn
from reart_tpu_torch import interop
from reart_tpu_torch.models import pointnet2 as tpn

torch.set_num_threads(1)

B, N = 2, 600


def _clouds(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 64, (B, N, 3)) / 64.0).astype(np.float32)


def _jax_tree(seed=0):
    """A random-init JAX tree with BatchNorm statistics and affines off
    their defaults, numpy leaves."""
    tree = jax.tree_util.tree_map(
        np.asarray, jpn.init_pointnet2msg2(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for path in jpn.bn_paths(tree):
        layer = tree
        for p in path:
            layer = layer[p]
        c = layer["b"].shape[0]
        layer["bn_w"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        layer["bn_b"] = (0.1 * rng.randn(c)).astype(np.float32)
        layer["bn_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        layer["bn_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return tree


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def tree():
    return _jax_tree()


@pytest.fixture(scope="module")
def model(tree):
    return interop.pointnet2_params_from_jax(tree, device="cpu")


def test_constants_and_bn_paths_match_jax(tree):
    for name in ("SA1", "SA2", "SA3_MLP", "SA3_IN", "FP3", "FP2", "FP1",
                 "BN_EPS", "CORR_NATIVE_FORMAT"):
        assert getattr(tpn, name) == getattr(jpn, name), name
    assert tpn.bn_paths() == jpn.bn_paths(tree)


def test_running_mode_features_match_jax(tree, model):
    xyz = _clouds()
    ref = np.asarray(jpn.apply_pointnet2msg2(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(xyz)))
    with torch.no_grad():
        got = model(torch.from_numpy(xyz))
    assert got.shape == (B, N, 64)
    # float32 matrix products summed in another order, 25 layers deep
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_batch_mode_features_and_moments_match_jax(tree, model):
    xyz = _clouds(1)
    stats_ref = []
    ref = np.asarray(jpn.apply_pointnet2msg2(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(xyz),
        bn_mode="batch", stats_out=stats_ref))
    stats = []
    with torch.no_grad():
        got = model(torch.from_numpy(xyz), bn_mode="batch", stats_out=stats)
    # 25 layers that each divide by the batch's own deviation (taken over
    # as few as 2 x 128 rows) amplify the rounding of the sums: rtol 1e-3,
    # and atol 5e-4 on features of order 1
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=5e-4)
    assert len(stats) == len(stats_ref) == len(tpn.bn_paths())
    for (m, v), (m_ref, v_ref) in zip(stats, stats_ref):  # bn_paths order
        np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-3,
                                   atol=1e-5)


def test_batch_variance_is_the_biased_one_and_ema_matches_jax(tree):
    """`apply_bn_ema` writes the biased batch variance, as the JAX package
    does (nn.BatchNorm would write the unbiased one)."""
    from reart_tpu.train.corr import apply_bn_ema as jax_ema

    model = interop.pointnet2_params_from_jax(tree, device="cpu")
    rng = np.random.RandomState(3)
    stats = [(rng.randn(c).astype(np.float32),
              rng.rand(c).astype(np.float32))
             for c in (tpn.layer_at(model, p).bias.shape[0]
                       for p in tpn.bn_paths())]
    ref = jax_ema(jax.tree_util.tree_map(jnp.asarray, tree),
                  [(jnp.asarray(m), jnp.asarray(v)) for m, v in stats], 0.1)
    tpn.apply_bn_ema(model, [(torch.from_numpy(m), torch.from_numpy(v))
                             for m, v in stats], 0.1)
    got = interop.pointnet2_params_to_numpy(model)
    for x, y in zip(_leaves(got), _leaves(ref)):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6, atol=1e-7)
    layer = tpn.ConvBN(3, 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(50, 3, generator=torch.Generator().manual_seed(1))
    stats = []
    layer(x, bn_mode="batch", stats_out=stats)
    y = torch.nn.functional.linear(x, layer.weight) + layer.bias
    torch.testing.assert_close(stats[0][1], y.var(0, unbiased=False))


def test_interop_round_trip_is_exact(tree, model):
    _assert_trees_equal(interop.pointnet2_params_to_numpy(model), tree)
    with pytest.raises(ValueError):  # a leaf of the wrong shape says where
        bad = jax.tree_util.tree_map(np.copy, tree)
        bad["fp2"][0]["w"] = bad["fp2"][0]["w"][:-1]
        interop.pointnet2_params_from_jax(bad, device="cpu")


def test_state_dict_round_trip_matches_jax(tree, model):
    sd_ref = jpn.export_torch_state_dict(tree)
    sd = tpn.export_torch_state_dict(model)
    assert sd.keys() == sd_ref.keys()
    for k, v in sd_ref.items():
        assert sd[k].shape == np.asarray(v).shape, k
        np.testing.assert_array_equal(sd[k], np.asarray(v), err_msg=k)
    # 'module.' / 'net.' prefixes are stripped on load
    back = tpn.load_torch_state_dict(
        {f"module.net.{k}": torch.from_numpy(np.array(v))
         for k, v in sd.items()}, device="cpu")
    _assert_trees_equal(interop.pointnet2_params_to_numpy(back), tree)


@pytest.mark.parametrize("fmt", ["native", "torch"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_written_by_one_package_loads_in_the_other(
        tree, model, tmp_path, fmt, writer):
    path = str(tmp_path / ("corr.pkl" if fmt == "native" else "corr.pth.tar"))
    if writer == "jax":
        save = (jpn.save_corr_model if fmt == "native"
                else jpn.save_corr_model_torch)
        save(path, jax.tree_util.tree_map(jnp.asarray, tree))
        got = interop.pointnet2_params_to_numpy(
            tpn.load_corr_model(path, device="cpu"))
    else:
        save = (tpn.save_corr_model if fmt == "native"
                else tpn.save_corr_model_torch)
        save(path, model)
        got = jax.tree_util.tree_map(np.asarray, jpn.load_corr_model(path))
    _assert_trees_equal(got, tree)
    if fmt == "native" and writer == "port":
        with open(path, "rb") as f:
            obj = pickle.load(f)  # numpy leaves only: no torch in the file
        assert obj["format"] == "reart_tpu_corr_v1"
        assert all(isinstance(x, np.ndarray) for x in _leaves(obj["params"]))


def test_module_defaults_to_the_card_and_draws_torch_defaults(monkeypatch):
    m = tpn.PointNet2Msg2(32, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert m.out_dim == 32 and len(list(m.parameters())) == 4 * 25
    w = m.sa1[0][0].weight
    assert w.shape == (32, 6) and float(w.detach().abs().max()) <= 1 / np.sqrt(6)
    assert float(m.head.running_var.min()) == 1.0
    with pytest.raises(ValueError):
        m(torch.zeros(1, 40, 3), bn_mode="frozen")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpn.PointNet2Msg2()
