"""Port parity: the trainer of the correspondence backbone
(reart_tpu_torch.train.corr) against the JAX package, on the same numpy frames, weights (through
interop.pointnet2_params_from_jax) and random draws.

The JAX trainer draws from `jax.random` keys; `_jax_draws` makes the draws
of one key exactly as `reart_tpu.train.corr.synth_pair` does and hands them
to the port's `synth_pair`, which is a pure function of them. Everything runs
at one small size (frames of 360 points, clouds of 128, batch 2)."""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reart_tpu.models import pointnet2 as jpn
from reart_tpu.train import corr as jcorr
from reart_tpu_torch import interop
from reart_tpu_torch.data.synth import make_toy_robot_sample
from reart_tpu_torch.models import pointnet2 as tpn
from reart_tpu_torch.train import corr as tcorr

torch.set_num_threads(1)

N0, N, BATCH = 360, 128, 2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def frames():
    """The toy robot's four frames, normalised into the unit ball."""
    pcs = make_toy_robot_sample()["complete_pc_list"]
    return (pcs / np.linalg.norm(pcs, axis=-1).max()).astype(np.float32)


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, jpn.init_pointnet2msg2(jax.random.PRNGKey(0)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_draws(keys, f_count, n0, cfg):
    """The draws `jcorr.synth_pair(key, ...)` makes from each key of `keys`,
    in the port's form (see tcorr.draw_pairs), stacked over the keys."""
    out = []
    for key in keys:
        kf, kp, ks, kk, kax, kan, ktr, kga, kgan, kgt, kj1, kj2, ksc = (
            jax.random.split(key, 13))
        n, k = cfg.n_points, cfg.k_parts
        out.append({
            "frame": jax.random.randint(kf, (), 0, f_count),
            "perm": jax.random.permutation(kp, n0),
            "seed_perm": jax.random.permutation(ks, n),
            "k_active": jax.random.randint(kk, (), cfg.min_parts, k + 1),
            "axis": jax.random.normal(kax, (k, 3)),
            "angle": jax.random.uniform(kan, (k, 1), minval=-cfg.max_angle,
                                        maxval=cfg.max_angle),
            "slide": jax.random.normal(ktr, (k, 3)),
            "gaxis": jax.random.normal(kga, (3,)),
            "gangle": jax.random.uniform(kgan, (), minval=-cfg.global_angle,
                                         maxval=cfg.global_angle),
            "gslide": jax.random.normal(kgt, (3,)),
            "jitter_src": jax.random.normal(kj1, (n, 3)),
            "jitter_tgt": jax.random.normal(kj2, (n, 3)),
            "scale": jax.random.uniform(ksc, (), minval=1 - cfg.scale_jitter,
                                        maxval=1 + cfg.scale_jitter),
        })
    return {name: np.stack([np.asarray(d[name]) for d in out])
            for name in out[0]}


def _configs(**kw):
    base = dict(n_points=N, batch=BATCH, steps=3, dispatch_chunk=3)
    base.update(kw)
    return jcorr.CorrTrainConfig(**base), tcorr.CorrTrainConfig(**base)


def test_config_defaults_match_jax():
    ref = dataclasses.asdict(jcorr.CorrTrainConfig())
    got = dataclasses.asdict(tcorr.CorrTrainConfig())
    # the tunnel watchdog has no counterpart
    assert ref.pop("dispatch_timeout") == 1800.0
    assert got == ref
    assert tcorr.FAR_POS == jcorr.FAR_POS


@pytest.mark.parametrize("resample", [True, False])
def test_synth_pair_from_injected_draws_matches_jax(frames, resample):
    jcfg, tcfg = _configs(resample=resample)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    ref = jax.vmap(lambda k: jcorr.synth_pair(k, jnp.asarray(frames), jcfg))(
        keys)
    got = tcorr.synth_pair(_jax_draws(keys, frames.shape[0], N0, jcfg),
                           _t(frames), tcfg)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    src, tgt, gt_pos, scale = got
    if not resample:  # the identity recipe: tgt is gt_pos plus jitter
        assert float((tgt - gt_pos).abs().max()) < 6 * tcfg.jitter * 1.15


def test_draw_pairs_makes_what_synth_pair_reads(frames):
    _, cfg = _configs()
    gen = torch.Generator().manual_seed(0)
    draws = tcorr.draw_pairs(gen, frames.shape[0], N0, cfg)
    ref = _jax_draws(jax.random.split(jax.random.PRNGKey(0), BATCH),
                     frames.shape[0], N0, cfg)
    assert draws.keys() == ref.keys()
    for k, v in draws.items():
        assert tuple(v.shape) == ref[k].shape, k
    assert (torch.sort(draws["perm"], -1)[0] == torch.arange(N0)).all()
    assert float(draws["angle"].abs().max()) <= cfg.max_angle
    assert 1 - cfg.scale_jitter <= float(draws["scale"].min())
    assert int(draws["k_active"].min()) >= cfg.min_parts
    assert int(draws["k_active"].max()) <= cfg.k_parts
    again = tcorr.draw_pairs(torch.Generator().manual_seed(0),
                             frames.shape[0], N0, cfg)
    assert all(torch.equal(draws[k], again[k]) for k in draws)
    src, tgt, gt_pos, scale = tcorr.synth_pair(draws, _t(frames), cfg)
    assert src.shape == tgt.shape == gt_pos.shape == (BATCH, N, 3)
    assert torch.isfinite(src).all() and torch.isfinite(tgt).all()


def _pair_on_a_grid(seed, resample):
    """(src, tgt, gt_pos) on a 1/64 grid, where the ball queries and 3-NN
    searches of both packages see exact distances clear of every radius:
    half of tgt's points are src points carried by the motion."""
    rng = np.random.RandomState(seed)
    cells = rng.permutation(24 ** 3)[: 2 * N * BATCH].reshape(BATCH, 2 * N)
    pts = (np.stack(np.unravel_index(cells, (24, 24, 24)), -1) / 64.0)
    src = pts[:, :N]
    move = np.array([2, -1, 3]) / 64.0
    gt_pos = src + move
    if resample:
        tgt = np.concatenate([gt_pos[:, : N // 2], pts[:, N: N + N // 2]], 1)
        tgt = tgt[:, rng.permutation(N)]
    else:
        tgt = gt_pos
    f32 = lambda x: x.astype(np.float32)
    return f32(src), f32(tgt), f32(gt_pos)


@pytest.mark.parametrize("resample", [False, True])
def test_info_nce_loss_and_gradients_match_jax(tree, resample):
    """The loss and the gradient of every parameter: plain autograd against
    the JAX package's hand-written VJP of the tail.

    Both backbones run in float64 here (the tails stay float32 in both), and
    agree to rtol 1e-4. In float32 they cannot be held to each other: the
    gradient passes through 25 BatchNorm backwards, each the small
    difference of large sums over up to 262,144 rows, and XLA:CPU adds such
    a sum one row at a time. Against the float64 gradient its float32 one is
    off by 2 to 15 per cent of the norm, layer by layer, the port's by 0.4
    per cent at most; the last assertion holds the port's float32 gradient
    to its float64 one. A conv bias in front of a batch-statistics
    BatchNorm has no gradient: both packages compute rounding noise there."""
    src, tgt, gt_pos = _pair_on_a_grid(1, resample)
    gp = gt_pos if resample else None

    with jax.enable_x64(True):
        f64 = lambda x: None if x is None else jnp.asarray(x, jnp.float64)

        def jax_loss(p):
            return jcorr.corr_info_nce(p, f64(src), f64(tgt), 0.07,
                                       "float64", f64(gp), 0.02, 0.05,
                                       jnp.ones((BATCH,), jnp.float32))

        (loss_ref, stats_ref), grads_ref = jax.jit(jax.value_and_grad(
            jax_loss, has_aux=True))(jax.tree_util.tree_map(f64, tree))
        loss_ref = float(loss_ref)
        stats_ref = [(np.asarray(m), np.asarray(v)) for m, v in stats_ref]
        grads_ref = jax.tree_util.tree_map(np.asarray, grads_ref)

    def port(dtype):
        model = interop.pointnet2_params_from_jax(tree, device="cpu").to(dtype)
        t = lambda x: None if x is None else _t(x).to(dtype)
        loss, stats = tcorr.corr_info_nce(
            model, t(src), t(tgt), 0.07, "float32", t(gp), 0.02, 0.05,
            torch.ones(BATCH))
        loss.backward()
        return model, loss.item(), stats

    model, loss, stats = port(torch.float64)
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    assert loss > 1.0  # positives exist: the loss is about ln N
    for (m, v), (m_ref, v_ref) in zip(stats, stats_ref):  # bn_paths order
        np.testing.assert_allclose(m.detach().numpy(), m_ref, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(v.detach().numpy(), v_ref, rtol=1e-5,
                                   atol=1e-7)
    names = {"w": "weight", "b": "bias", "bn_w": "bn_weight",
             "bn_b": "bn_bias"}
    model32, loss32, _ = port(torch.float32)
    np.testing.assert_allclose(loss32, loss, rtol=1e-4)
    for path in tpn.bn_paths():
        layer, layer32 = tpn.layer_at(model, path), tpn.layer_at(model32, path)
        leaf = grads_ref
        for p in path:
            leaf = leaf[p]
        top = np.abs(leaf["w"]).max()
        for key, name in names.items():
            g = getattr(layer, name).grad.numpy()
            g32 = getattr(layer32, name).grad.numpy()
            g_ref = leaf[key].T if key == "w" else leaf[key]
            if key == "b":
                assert max(np.abs(g).max(), np.abs(g_ref).max(),
                           np.abs(g32).max()) < 1e-4 * top, (path, "bias")
                continue
            # atol: 1e-5 of the layer's largest weight gradient (a shift
            # that the next batch normalisation cancels has none either)
            np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-5 * top,
                                       err_msg=f"{path} {key}")
            assert (np.linalg.norm(g32 - g)
                    <= 2e-2 * np.linalg.norm(g) + 1e-4 * top), (path, key)


def test_adam_steps_match_optax():
    """The optimizer of the trainer: torch.optim.Adam against optax.adam on
    one injected gradient sequence, rtol 1e-6."""
    import optax

    rng = np.random.RandomState(0)
    w0 = rng.randn(5, 7).astype(np.float32)
    grads = [(rng.randn(5, 7) * 10.0 ** -k).astype(np.float32)
             for k in range(4)]
    tx = optax.adam(1e-3)
    params, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    w = torch.nn.Parameter(_t(w0.copy()))
    opt = torch.optim.Adam([w], lr=1e-3)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        w.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params),
                                   rtol=1e-6, atol=1e-8)


def test_three_training_steps_match_jax(frames, tree):
    """Three Adam steps of train_corr at the default learning rate from the
    same weights and draws: the loss history within rtol 1e-3, every
    parameter's change within 5 per cent of its leaf's norm, and the running
    statistics after the steps.

    Both packages run the backbone pass in float64 from their float32 master
    weights (compute_dtype="float64"): XLA:CPU's float32 gradient of this
    network is off by several per cent of its norm (see
    test_info_nce_loss_and_gradients_match_jax), and Adam's first steps move
    every weight by the learning rate in the direction of its gradient's
    sign, so in float32 the two runs part by 6e-2 of the loss within three
    steps. In float64 what is left is the sign of the entries whose gradient
    is rounding noise: 1 to 3.5 per cent of a leaf's change. A trainer that
    does not step, steps on a stale gradient or lets gradients pile up is off
    by the whole of it. A parameter without a gradient (a conv bias in front
    of a batch-statistics BatchNorm) must not move. The JAX trainer runs its chunk in
    another thread, so float64 is switched on for the process, not for this
    thread, and off again."""
    jcfg, tcfg = _configs(pos_radius=0.08, neg_radius=0.2,
                          compute_dtype="float64")
    assert tcfg.lr == tcorr.CorrTrainConfig().lr == 1e-3
    key = jax.random.PRNGKey(3)
    jax.config.update("jax_enable_x64", True)
    try:
        params_ref, losses_ref = jcorr.train_corr(key, frames, jcfg,
                                                  params=_jnp(tree))
        params_ref = jax.tree_util.tree_map(np.asarray, params_ref)
        losses_ref = np.asarray(losses_ref)
        # the keys train_corr derives: one chunk of 3 steps, BATCH pairs each
        _, sub = jax.random.split(key)
        step_keys = jax.random.split(sub, 3)
        draws = [_jax_draws(jax.random.split(k, BATCH), frames.shape[0], N0,
                            jcfg) for k in step_keys]
    finally:
        jax.config.update("jax_enable_x64", False)
    # the port makes its pairs in float32
    draws = [{k: v.astype(np.float32) if v.dtype == np.float64 else v
              for k, v in d.items()} for d in draws]
    model = interop.pointnet2_params_from_jax(tree, device="cpu")
    model, losses = tcorr.train_corr(0, frames, tcfg, model=model,
                                     device="cpu", draws=lambda s: draws[s])
    assert losses.shape == (3,) and losses[0] > 1.0
    assert len(set(np.round(losses, 3))) == 3  # three different batches
    np.testing.assert_allclose(losses, losses_ref, rtol=1e-3)
    got = interop.pointnet2_params_to_numpy(model)
    for path in tpn.bn_paths():
        a, b, start = got, params_ref, tree
        for p in path:
            a, b, start = a[p], b[p], start[p]
        for key in ("w", "bn_w", "bn_b", "b"):
            step, step_ref = a[key] - start[key], b[key] - start[key]
            if np.abs(step_ref).max() < 1e-6:
                # no gradient: a conv bias, and the shift of the global
                # feature, which the next batch normalisation cancels
                assert key != "w" and np.abs(step).max() < 1e-5, (path, key)
                continue
            size = np.linalg.norm(step_ref)
            # three steps of about the learning rate on every entry
            assert size > 1e-3 * np.sqrt(step_ref.size), (path, key)
            assert np.linalg.norm(step - step_ref) <= 5e-2 * size, (path, key)
        # the weights of the later steps differ as far as stated above
        np.testing.assert_allclose(a["bn_mean"], b["bn_mean"], rtol=1e-2,
                                   atol=1e-3, err_msg=str(path))
        np.testing.assert_allclose(a["bn_var"], b["bn_var"], rtol=1e-2,
                                   atol=1e-5, err_msg=str(path))
        assert not np.allclose(a["bn_var"], 1.0)  # the statistics moved


@pytest.fixture
def deterministic():
    """Sums of the gathers' backward in one fixed order, so that two runs
    of one process agree bit for bit."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_resumed_training_equals_the_uninterrupted_run(frames, tmp_path,
                                                       deterministic):
    cfg = tcorr.CorrTrainConfig(n_points=N, batch=BATCH, steps=2,
                                dispatch_chunk=1, checkpoint_every=1,
                                pos_radius=0.08, neg_radius=0.2)
    full, losses_full = tcorr.train_corr(7, frames, cfg, device="cpu")
    path = str(tmp_path / "train.ckpt")
    half_cfg = dataclasses.replace(cfg, steps=1)
    tcorr.train_corr(7, frames, half_cfg, device="cpu", checkpoint_path=path)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert saved["done"] == 1 and saved["format"] == tcorr.TRAIN_CKPT_FORMAT
    seen = []
    resumed, losses = tcorr.train_corr(
        7, frames, cfg, device="cpu", checkpoint_path=path,
        log_fn=lambda done, loss: seen.append(done))
    assert seen == [1, 2]  # resumed at 1, one more chunk
    np.testing.assert_array_equal(losses, losses_full)
    for (k, a), (_, b) in zip(resumed.state_dict().items(),
                              full.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError):
        tcorr.train_corr(7, frames[:, :100], cfg, device="cpu")


def test_bf16_and_finetune_run_and_stay_finite(frames):
    cfg = tcorr.CorrTrainConfig(n_points=N, batch=BATCH, steps=1,
                                compute_dtype="bfloat16", pos_radius=0.08,
                                neg_radius=0.2)
    model, losses = tcorr.train_corr(1, frames, cfg, device="cpu")
    assert np.isfinite(losses).all() and losses[0] > 1.0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    rounds = []
    before = model.head.weight.detach().clone()
    model, ft = tcorr.finetune_real_pairs(
        2, model, frames, dataclasses.replace(cfg, compute_dtype="float32"),
        steps=2, rounds=2, refine_k=4, device="cpu",
        log_fn=lambda r, matched: rounds.append(matched))
    assert ft.shape == (2,) and np.isfinite(ft).all()
    assert len(rounds) == 2 and all(0.0 <= m <= 1.0 for m in rounds)
    assert not torch.equal(before, model.head.weight)
    with pytest.raises(ValueError):
        tcorr.corr_info_nce(model, _t(frames[:1, :N]), _t(frames[:1, :N]),
                            0.07, "float16")


def test_mine_pair_labels_and_match_precision_on_identical_frames(frames,
                                                                  tree):
    """Identical frames: every point matches itself, so the mined targets
    are the points; a refinement over matched neighbours keeps them."""
    model = interop.pointnet2_params_from_jax(tree, device="cpu")
    same = _t(np.stack([frames[0], frames[0], frames[1]]))
    gt = tcorr.mine_pair_labels(model, same, th=0.99)
    assert gt.shape == (2, N0, 3)
    np.testing.assert_array_equal(gt[0].numpy(), frames[0])
    matched = gt[1, :, 0] < tcorr.FAR_POS / 2
    assert (gt[1][~matched] == tcorr.FAR_POS).all()
    refined = tcorr._refine_mined_labels(same.numpy(), gt.numpy(), 8)
    np.testing.assert_allclose(refined[0], frames[0], atol=1e-4)
    prec, rate = tcorr.match_precision(model, same[0], same[1], th=0.99)
    assert (prec, rate) == (1.0, 1.0)
    prec, rate = tcorr.match_precision(model, same[0], same[1], th=0.99,
                                       gt_pos=same[0] + 1.0)
    assert (prec, rate) == (0.0, 1.0)
