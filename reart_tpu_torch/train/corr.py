"""Self-supervised training of the correspondence backbone
(reart_tpu/train/corr.py).

The backbone is trained on synthetic rigid-part deformations of the
sequence's own frames, with no labels: sample a frame, subsample N points,
split them into K random Voronoi parts, move every part by a random screw
(a rotation about its centroid and a slide), add a global motion and
per-point jitter, embed both clouds with the same backbone in one batched
pass and train with a bidirectional InfoNCE over the (N, N) similarity
logits. BatchNorm runs on batch moments, which are written back into the
running statistics after every step (`apply_bn_ema`), so the trained module
drops straight into the frozen inference path.

Random draws are separate from their use: `draw_pairs` makes one step's
draws from a `torch.Generator`, and `synth_pair` is a pure function of
them, so a test can hand this package and the JAX package the same numbers.
The step loop is a plain Python loop; `dispatch_chunk` is the cadence of
the log line and (times `checkpoint_every`) of the checkpoint. The
checkpoint holds the generator's state beside the weights and the optimizer
state, so a resumed run draws what the uninterrupted one draws; the two are
equal bit for bit under `torch.use_deterministic_algorithms(True)` (the
backward of the gathers adds in an order that otherwise changes from run to
run).

With tracing on (profiling.py) a run is the span `corr.train`, each step a
`corr.step` holding `corr.draws`, `corr.synth`, `corr.forward` (the
backbone's blocks and BatchNorms inside), `corr.loss`, `corr.backward`
and `corr.update`; `corr.log` and `corr.checkpoint` lie between steps, and
the counter `corr.steps` counts the steps done (fine-tuning's too).

Precision: float32 matrix products (no TF32) unless `compute_dtype` is
"bfloat16", which runs the backbone's matrix products under
`torch.autocast(bfloat16)` with float32 weights, BatchNorm moments, logits
and loss. "float64" casts the float32 weights and the clouds to double for
the backbone pass (no card runs it fast: it is how the tests hold a training
step to the JAX package clear of float32 summation error).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import warnings

import torch
from torch.nn import functional as F

from reart_tpu_torch import resolve_device, tree_to_numpy
from reart_tpu_torch.geometry import so3_exp_map
from reart_tpu_torch.models.pointnet2 import PointNet2Msg2, apply_bn_ema
from reart_tpu_torch.ops.sampling import index_points
from reart_tpu_torch.profiling import count, span
from reart_tpu_torch.train.engine import _to_device

TRAIN_CKPT_FORMAT = "reart_tpu_torch_corr_train_v1"

FAR_POS = 1e6  # pseudo-label sentinel: fails every pos_radius gate


@dataclasses.dataclass(frozen=True)
class CorrTrainConfig:
    steps: int = 2000
    batch: int = 4                # pairs per step
    n_points: int = 1024          # points per cloud during training
    k_parts: int = 8              # max synthetic rigid parts per example
    min_parts: int = 2
    max_angle: float = 0.6        # rad, per-part rotation about its centroid
    max_slide: float = 0.08       # per-part translation (input units)
    jitter: float = 0.004         # per-point gaussian noise (input units)
    global_angle: float = 0.25    # global rotation applied to the target
    global_slide: float = 0.08
    scale_jitter: float = 0.15    # +-15% uniform rescale of the pair
    temperature: float = 0.07     # InfoNCE logit temperature
    lr: float = 1e-3
    bn_momentum: float = 0.1      # torch BatchNorm default
    dispatch_chunk: int = 50      # steps per log line
    out_dim: int = 64             # feature width
    seed_frames: int = 0          # 0 = use all frames
    compute_dtype: str = "float32"  # "bfloat16", "float64": see above
    checkpoint_every: int = 10    # chunks between checkpoint rewrites
    # resampled pairs: src and tgt are independent subsets of the frame, as
    # two scans are independent samplings of a surface. Positives come from
    # the nearest tgt point of each src point's true transformed position
    # (gt_pos), gated by pos_radius; near-misses inside neg_radius are left
    # out of the negatives.
    resample: bool = True
    pos_radius: float = 0.02      # max |gt_pos - nn(tgt)| for a positive
    neg_radius: float = 0.05      # no-penalty zone around gt_pos


# ---------------------------------------------------------------------------
# synthetic pairs
# ---------------------------------------------------------------------------

def draw_pairs(generator: torch.Generator, f_count: int, n0: int,
               cfg: CorrTrainConfig, batch: int | None = None) -> dict:
    """The random draws of `batch` synthetic pairs, on the generator's
    device, each with a leading batch axis:
      frame (B,) int64 frame index; perm (B, n0) a permutation of the
      frame's points; seed_perm (B, n) a permutation of the n source points
      (its first k_parts are the Voronoi seeds); k_active (B,) int64 in
      [min_parts, k_parts]; axis (B, K, 3) normal; angle (B, K, 1) uniform
      in +-max_angle; slide (B, K, 3) normal; gaxis (B, 3) normal; gangle
      (B,) uniform in +-global_angle; gslide (B, 3) normal; jitter_src,
      jitter_tgt (B, n, 3) normal; scale (B,) uniform in
      1 +- scale_jitter."""
    b = cfg.batch if batch is None else batch
    n, k = cfg.n_points, cfg.k_parts
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def uniform(half_width, *shape):
        u = torch.rand(shape, generator=generator, device=dev)
        return (2.0 * u - 1.0) * half_width

    def randint(lo, hi):
        return torch.randint(lo, hi, (b,), generator=generator, device=dev)

    def perms(m):
        return torch.argsort(torch.rand((b, m), generator=generator,
                                        device=dev), dim=-1)

    return {
        "frame": randint(0, f_count), "perm": perms(n0),
        "seed_perm": perms(n), "k_active": randint(cfg.min_parts, k + 1),
        "axis": normal(b, k, 3), "angle": uniform(cfg.max_angle, b, k, 1),
        "slide": normal(b, k, 3), "gaxis": normal(b, 3),
        "gangle": uniform(cfg.global_angle, b), "gslide": normal(b, 3),
        "jitter_src": normal(b, n, 3), "jitter_tgt": normal(b, n, 3),
        "scale": 1.0 + uniform(cfg.scale_jitter, b),
    }


def synth_pair(draws: dict, frames: torch.Tensor, cfg: CorrTrainConfig):
    """A batch of synthetic training pairs from the sequence's own frames,
    a pure function of `draws` (see draw_pairs).

    frames (F, N0, 3): clouds normalised as inference will normalise them.
    Returns (src (B, N, 3), tgt (B, N, 3), gt_pos (B, N, 3), scale (B,)):
    gt_pos[b, i] is src[b, i]'s true (jitter-free) position in tgt's frame;
    scale is the pair's rescale factor, by which the radius gates of
    corr_info_nce are multiplied. With cfg.resample False tgt is the same
    point set as src (correspondence i <-> i); with resample True tgt is an
    independent subset of the frame moved by the same part and global
    motion, and the loss derives positives from gt_pos."""
    n0 = frames.shape[1]
    n, k_max = cfg.n_points, cfg.k_parts
    dev = frames.device
    d = {k: torch.as_tensor(v, device=dev) for k, v in draws.items()}

    cloud = frames[d["frame"]]                                  # (B, N0, 3)
    x = index_points(cloud, d["perm"][:, :n])                   # (B, N, 3)
    # independent target subset: disjoint iff n0 >= 2n
    x2 = index_points(cloud, d["perm"][:, n0 - n:]) if cfg.resample else x

    # Voronoi split around K random seed points; a random subset of seeds
    # is active, so the part count varies in [min_parts, k_parts]
    seeds = index_points(x, d["seed_perm"][:, :k_max])          # (B, K, 3)
    active = (torch.arange(k_max, device=dev)[None, :]
              < d["k_active"][:, None])                         # (B, K)

    def voronoi_label(pts):
        d2 = torch.sum((pts[:, :, None] - seeds[:, None]) ** 2, dim=-1)
        inf = torch.full_like(d2, float("inf"))
        return torch.argmin(torch.where(active[:, None], d2, inf), dim=-1)

    label = voronoi_label(x)                                    # (B, N)
    onehot = F.one_hot(label, k_max).to(x.dtype)                # (B, N, K)
    counts = torch.sum(onehot, dim=1)                           # (B, K)
    centroids = (torch.matmul(onehot.transpose(1, 2), x)
                 / torch.clamp_min(counts, 1.0)[..., None])     # (B, K, 3)

    axis = d["axis"]
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-8)
    rot = so3_exp_map(axis * d["angle"])                        # (B, K, 3, 3)
    slide = cfg.max_slide * d["slide"]

    # global motion on the target (camera / root movement)
    gaxis = d["gaxis"]
    gaxis = gaxis / (torch.linalg.norm(gaxis, dim=-1, keepdim=True) + 1e-8)
    grot = so3_exp_map(gaxis * d["gangle"][:, None])            # (B, 3, 3)
    gslide = cfg.global_slide * d["gslide"]

    def move(pts, lab):
        c = index_points(centroids, lab)                        # (B, N, 3)
        r = index_points(rot.reshape(rot.shape[0], k_max, 9),
                         lab).reshape(lab.shape + (3, 3))
        out = (torch.einsum("bnij,bnj->bni", r, pts - c) + c
               + index_points(slide, lab))
        return (torch.matmul(out, grot.transpose(1, 2))
                + gslide[:, None, :])

    gt_pos = move(x, label)                   # src's true target position
    y = move(x2, voronoi_label(x2)) if cfg.resample else gt_pos

    x = x + cfg.jitter * d["jitter_src"]
    y = y + cfg.jitter * d["jitter_tgt"]
    s = d["scale"]
    sb = s[:, None, None]
    return x * sb, y * sb, gt_pos * sb, s


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _nce_dir(lg, is_pos, near, valid):
    """Per-direction gated cross entropy: the mean over valid rows of
    logsumexp(masked logits) minus the positive logit."""
    lgm = torch.where(near, torch.full_like(lg, -1e9), lg)
    lse = torch.logsumexp(lgm, dim=-1)
    pos_lg = torch.sum(torch.where(is_pos, lgm, torch.zeros_like(lgm)),
                       dim=-1)
    return torch.sum((lse - pos_lg) * valid) / torch.clamp_min(
        torch.sum(valid), 1.0)


def corr_info_nce(model: PointNet2Msg2, src, tgt, temperature: float,
                  compute_dtype: str = "float32", gt_pos=None,
                  pos_radius: float = 0.02, neg_radius: float = 0.05,
                  scale=None):
    """Bidirectional InfoNCE. src / tgt (B, N, 3). Returns (loss, bn_stats):
    the backbone runs one batched pass over the 2B clouds in "batch" mode,
    so the batch moments are shared; bn_stats lists them in `bn_paths`
    order (float32).

    gt_pos None (identity recipe): src[i] corresponds to tgt[i], the labels
    are the diagonal. gt_pos (B, N, 3) (resampled recipe): src[i]'s positive
    is the tgt point nearest to gt_pos[i], valid only within pos_radius; any
    other tgt point inside neg_radius of gt_pos[i] is masked out of the
    negatives (with -1e9, not -inf). The reverse direction likewise with the
    roles swapped. scale (B,): the per-pair rescale factor of synth_pair, by
    which both radii are multiplied. The gates are constants: no gradient
    passes through them. Plain autograd differentiates the tail.

    With tracing on the backbone's pass is the span `corr.forward` and the
    rest (normalisation, gates, logits, loss) `corr.loss`."""
    stats = []
    both = torch.cat([src, tgt], dim=0)
    kw = dict(bn_mode="batch", stats_out=stats)
    with span("corr.forward", src.device):
        if compute_dtype == "float64":
            # the weights cast for the pass: gradients reach the float32 ones
            cast = {k: v.double() for k, v in model.named_parameters()}
            feats = torch.func.functional_call(model, cast, (both.double(),),
                                               kw)
        elif compute_dtype == "bfloat16":
            with torch.autocast(device_type=both.device.type,
                                dtype=torch.bfloat16):
                feats = model(both, **kw)
        elif compute_dtype == "float32":
            feats = model(both, **kw)
        else:
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32, "
                             f"bfloat16 or float64")
    with span("corr.loss", src.device):
        b, n = src.shape[0], src.shape[1]
        feats = feats.to(torch.float32)
        stats = [(m.to(torch.float32), v.to(torch.float32)) for m, v in stats]
        feats = feats / (torch.linalg.norm(feats, dim=-1, keepdim=True) + 1e-8)
        f1, f2 = feats[:b], feats[b:]

        with torch.no_grad():
            if gt_pos is None:
                is_pos = torch.eye(n, dtype=torch.bool,
                                   device=src.device).expand(b, n, n)
                near = torch.zeros((b, n, n), dtype=torch.bool,
                                   device=src.device)
                valid = torch.ones((b, n), dtype=torch.float32,
                                   device=src.device)
                gates_f = gates_b = (is_pos, near, valid)
            else:
                # from each src point's true position to every tgt point
                d2 = torch.sum((gt_pos[:, :, None] - tgt[:, None]) ** 2,
                               dim=-1)
                s = (torch.ones((b,), dtype=torch.float32, device=src.device)
                     if scale is None else
                     torch.as_tensor(scale, dtype=torch.float32,
                                     device=src.device))
                pos_r2 = (pos_radius * s)[:, None] ** 2          # (B, 1)
                neg_r2 = (neg_radius * s)[:, None, None] ** 2    # (B, 1, 1)

                def gates(d2):
                    dmin, pos = torch.min(d2, dim=-1)
                    valid = (dmin < pos_r2).to(torch.float32)
                    is_pos = F.one_hot(pos, d2.shape[-1]).to(torch.bool)
                    return is_pos, (d2 < neg_r2) & ~is_pos, valid

                gates_f = gates(d2)
                gates_b = gates(d2.transpose(1, 2))

        lg = torch.einsum("bnd,bmd->bnm", f1, f2) * (1.0 / temperature)
        loss = 0.5 * (_nce_dir(lg, *gates_f)
                      + _nce_dir(lg.transpose(1, 2), *gates_b))
        return loss, stats


def _train_step(model, opt, cfg: CorrTrainConfig, src, tgt, gt_pos, scale):
    """One Adam step and the running-statistics update; returns the loss.
    Spans: `corr.forward` and `corr.loss` (in corr_info_nce),
    `corr.backward` (with `zero_grad`, which frees the gradients and
    launches nothing), `corr.update` (Adam, apply_bn_ema)."""
    dev = src.device
    loss, stats = corr_info_nce(
        model, src, tgt, cfg.temperature, cfg.compute_dtype, gt_pos,
        cfg.pos_radius, cfg.neg_radius, scale)
    with span("corr.backward", dev):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    with span("corr.update", dev):
        opt.step()
        apply_bn_ema(model, stats, cfg.bn_momentum)
    return loss.detach()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _save_train_ckpt(path, model, opt, generator, done, losses):
    payload = {"format": TRAIN_CKPT_FORMAT,
               "model": tree_to_numpy(dict(model.state_dict())),
               "opt_state": tree_to_numpy(opt.state_dict()),
               "rng": generator.get_state().cpu().numpy(),
               "done": done, "losses": tree_to_numpy(losses[:done])}
    with open(path + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(path + ".tmp", path)  # atomic: never half a file


def _load_train_ckpt(path, model, opt, generator, dev):
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if obj.get("format") != TRAIN_CKPT_FORMAT:
        raise ValueError(f"{path}: not a {TRAIN_CKPT_FORMAT} checkpoint")
    model.load_state_dict(_to_device(obj["model"], dev))
    opt.load_state_dict(_to_device(obj["opt_state"], dev))
    generator.set_state(torch.from_numpy(obj["rng"]))
    return int(obj["done"]), obj["losses"]


def train_corr(seed: int, frames, cfg: CorrTrainConfig = CorrTrainConfig(),
               model: PointNet2Msg2 | None = None, log_fn=None,
               checkpoint_path: str | None = None, device=None, draws=None):
    """Train the backbone on frames (F, N0, 3) (normalised, see synth_pair)
    on `device` (the card when None). Returns (model, losses (steps,)
    numpy); the model is inference-ready: its running BatchNorm statistics
    carry the moving average of the training batches' moments.

    seed: of the weights (when `model` is None) and of the draws.
    draws(step) -> the draws of that step (see draw_pairs); by default from
    a generator on the device. log_fn(done, loss) is called every
    cfg.dispatch_chunk steps. checkpoint_path: if the file exists, training
    continues from it; it is rewritten (atomically) every
    cfg.checkpoint_every chunks and at the end."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    if cfg.seed_frames:
        frames = frames[: cfg.seed_frames]
    if frames.shape[1] < cfg.n_points:
        raise ValueError(f"frames have {frames.shape[1]} points, need >= "
                         f"{cfg.n_points}")
    if cfg.resample and 2 * cfg.n_points > frames.shape[1]:
        warnings.warn(
            f"resample=True with n_points={cfg.n_points} but frames of only "
            f"{frames.shape[1]} points: the src and tgt subsets overlap by "
            f"{2 * cfg.n_points - frames.shape[1]} points (at n_points == "
            f"frame size tgt is a permutation of src). Lower n_points or "
            f"resample.", stacklevel=2)
    if model is None:
        model = PointNet2Msg2(
            cfg.out_dim, device=dev,
            generator=torch.Generator().manual_seed(seed))
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    generator = torch.Generator(device=dev).manual_seed(seed)
    losses = torch.zeros(cfg.steps, dtype=torch.float32, device=dev)
    done = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        done, saved = _load_train_ckpt(checkpoint_path, model, opt,
                                       generator, dev)
        losses[:done] = torch.as_tensor(saved, device=dev)
        if log_fn is not None:
            log_fn(done, float(losses[done - 1]) if done else float("nan"))
    if draws is None:
        def draws(_step):
            return draw_pairs(generator, frames.shape[0], frames.shape[1],
                              cfg)

    chunk = max(1, cfg.dispatch_chunk)
    chunks_since_ckpt = 0
    with span("corr.train", dev):
        while done < cfg.steps:
            end = min(done + chunk, cfg.steps)
            for step in range(done, end):
                with span("corr.step", dev):
                    with span("corr.draws", dev):
                        d = draws(step)
                    with span("corr.synth", dev):
                        src, tgt, gt_pos, scale = synth_pair(d, frames, cfg)
                    losses[step] = _train_step(
                        model, opt, cfg, src, tgt,
                        gt_pos if cfg.resample else None, scale)
                count("corr.steps")
            done = end
            chunks_since_ckpt += 1
            if checkpoint_path and (chunks_since_ckpt >= cfg.checkpoint_every
                                    or done >= cfg.steps):
                with span("corr.checkpoint", dev):
                    _save_train_ckpt(checkpoint_path, model, opt, generator,
                                     done, losses)
                chunks_since_ckpt = 0
            if log_fn is not None:
                with span("corr.log", dev):
                    log_fn(done, float(losses[done - 1]))
        return model, losses.cpu().numpy()


# ---------------------------------------------------------------------------
# fine-tuning on the sequence's own consecutive pairs
# ---------------------------------------------------------------------------

@torch.no_grad()
def mine_pair_labels(model: PointNet2Msg2, frames: torch.Tensor,
                     th: float = 0.9) -> torch.Tensor:
    """SMNN-match every consecutive frame pair with the current backbone
    (running statistics: the matching inference will run). frames
    (F, N0, 3) normalised. Returns gt_pos (F-1, N0, 3): src point i's pseudo
    true position in frame t+1 (its matched tgt point), FAR_POS rows where
    unmatched."""
    from reart_tpu_torch.flow import match_smnn

    feats = model(frames)                                       # (F, N0, D)
    _, j, valid = match_smnn(feats[:-1], feats[1:], th)
    matched = index_points(frames[1:], j)
    return torch.where(valid[..., None], matched,
                       torch.full_like(matched, FAR_POS))


def _refine_mined_labels(frames_np, gt_np, k: int):
    """Host-side local-rigid refinement of mined pseudo-targets: each
    matched src point's discrete target is replaced by its matched
    neighbourhood's trimmed-Procrustes prediction
    (flow.refine_targets_local_rigid). Unmatched rows stay FAR_POS.
    frames_np (F, N0, 3), gt_np (F-1, N0, 3); returns a refined copy."""
    from reart_tpu_torch.flow import refine_targets_local_rigid

    out = gt_np.copy()
    for t in range(out.shape[0]):
        m = out[t, :, 0] < FAR_POS / 2
        if int(m.sum()) >= 5:
            out[t][m] = refine_targets_local_rigid(
                frames_np[t][m], out[t][m], k=k)
    return out


def _finetune_batch(generator, frames, gt_pos_all, real_frac: float,
                    cfg: CorrTrainConfig):
    """One fine-tuning batch: each element is a real consecutive pair (a
    random frame pair, independently subsampled src and tgt subsets, mined
    pseudo gt_pos) with probability real_frac, else a synthetic pair."""
    f_count, n0 = frames.shape[0], frames.shape[1]
    dev = frames.device
    b, n = cfg.batch, cfg.n_points

    def rand(*shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(dev)

    p = torch.randint(0, f_count - 1, (b,), generator=generator,
                      device=generator.device).to(dev)
    si = torch.argsort(rand(b, n0), dim=-1)[:, :n]
    ti = torch.argsort(rand(b, n0), dim=-1)[:, :n]
    use_real = rand(b) < real_frac
    src_r = index_points(frames[p], si)
    tgt_r = index_points(frames[p + 1], ti)
    gt_r = index_points(gt_pos_all[p], si)
    src_s, tgt_s, gt_s, sc_s = synth_pair(
        draw_pairs(generator, f_count, n0, cfg), frames, cfg)
    pick = use_real[:, None, None]
    return (torch.where(pick, src_r, src_s), torch.where(pick, tgt_r, tgt_s),
            torch.where(pick, gt_r, gt_s),
            torch.where(use_real, torch.ones_like(sc_s), sc_s))


def finetune_real_pairs(seed: int, model: PointNet2Msg2, frames,
                        cfg: CorrTrainConfig = CorrTrainConfig(),
                        steps: int = 600, mine_th: float = 0.9,
                        rounds: int = 3, real_frac: float = 0.5,
                        lr: float | None = None, log_fn=None,
                        refine_k: int = 0, device=None):
    """Fine-tune a trained backbone on the sequence's own consecutive frame
    pairs: mine the matcher's own SMNN matches on the real pairs, treat the
    matched target positions as pseudo ground truth, and train the
    radius-gated InfoNCE on real (src, tgt) clouds, re-mining `rounds`
    times; synthetic pairs keep flowing at 1 - real_frac. Returns (model,
    losses (steps,) numpy). mine_th: the SMNN ratio threshold of the
    pseudo-labels; lr defaults to 0.3 x cfg.lr; refine_k > 0 refines each
    round's mined targets (_refine_mined_labels); log_fn(round, matched
    share)."""
    dev = resolve_device(device)
    model = model.to(dev)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    if frames.shape[0] < 2:
        raise ValueError("need at least one consecutive pair")
    opt = torch.optim.Adam(model.parameters(),
                           lr=cfg.lr * 0.3 if lr is None else lr)
    generator = torch.Generator(device=dev).manual_seed(seed)
    per_round = -(-steps // max(rounds, 1))
    losses = []
    for r in range(max(rounds, 1)):
        gt_pos_all = mine_pair_labels(model, frames, th=mine_th)
        if refine_k > 0:
            gt_pos_all = torch.as_tensor(_refine_mined_labels(
                frames.cpu().numpy(), gt_pos_all.cpu().numpy(), refine_k),
                device=dev)
        if log_fn is not None:
            log_fn(r, float((gt_pos_all[..., 0] < FAR_POS / 2)
                            .to(torch.float32).mean()))
        for _ in range(per_round):
            with span("corr.step", dev):
                with span("corr.synth", dev):
                    src, tgt, gt_pos, scale = _finetune_batch(
                        generator, frames, gt_pos_all, real_frac, cfg)
                losses.append(_train_step(model, opt, cfg, src, tgt, gt_pos,
                                          scale))
            count("corr.steps")
    out = torch.stack(losses) if losses else torch.zeros(0)
    return model, out.cpu().numpy()


@torch.no_grad()
def match_precision(model: PointNet2Msg2, src, tgt, th: float = 0.9,
                    gt_pos=None, pos_radius: float = 0.02):
    """SMNN-match src -> tgt features (the inference matching); returns
    (precision, match_rate): the share of valid matches that are correct,
    and the share of points matched at all. gt_pos None: a match i -> j is
    correct iff j == i; gt_pos (N, 3): iff tgt[j] lies within pos_radius of
    gt_pos[i]."""
    from reart_tpu_torch.flow import match_smnn

    feats = model(torch.stack([src, tgt]))
    _, j, valid = match_smnn(feats[0], feats[1], th)
    if gt_pos is None:
        hit = j == torch.arange(src.shape[0], device=j.device)
    else:
        hit = torch.sum((tgt[j] - gt_pos) ** 2, dim=-1) < pos_radius ** 2
    correct = valid & hit
    n_valid = torch.clamp_min(torch.sum(valid), 1)
    return (float(torch.sum(correct) / n_valid),
            float(valid.to(torch.float32).mean()))
