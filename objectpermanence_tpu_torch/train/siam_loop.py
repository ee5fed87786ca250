"""SiamRPN tracker training on rendered scenes (template/search pairs), the
counterpart of `objectpermanence_tpu/train/siam_loop.py`.

The same network as `models/siam.py`, trained from scratch with the SiamRPN
recipe (Li et al., CVPR'18): template 127 and search 271 crops of one object
dt frames apart, per-anchor softmax classification (IoU >= 0.6 positive,
< 0.3 negative, the best anchor always positive, a balanced sample) and a
smooth-L1 regression of (dx/aw, dy/ah, log gw/aw, log gh/ah), the inverse
of `tracker_update`'s decode.

Pairs are cropped once on the host into a dense uint8 npz (the crop
geometry of `SiamRPNTracker.init/track`, with the reference's w/h swap);
training keeps them on the device as uint8. Batch norm uses the batch's
statistics (biased variance, as `jnp.var`), and an EMA of them (momentum
0.1) is written into the running statistics after each update, so the
frozen-BN forward of `models/siam.py` serves the trained weights.

The optimizer is JAX's optax chain `clip_by_global_norm(10)` -> `sgd(
warmup_cosine_decay_schedule, momentum=0.9)`: a `torch.optim.SGD` (dampening
0, whose momentum buffer `g + 0.9 * buf` is optax's trace) whose learning
rate is set to the schedule at the count of updates so far before each
step. The balanced sample ranks anchors by uniform draws from a
`torch.Generator`; the loss takes its masks as arguments, so a test can pass
JAX's.
"""

import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.models import siam
from objectpermanence_tpu_torch.models.detector.training import (
    BELOW_LOW, BETWEEN, balanced_sample, clip_by_global_norm_, smooth_l1,
)
from objectpermanence_tpu_torch.ops.boxes import pairwise_iou_xyxy

EXEMPLAR = siam.SiamRPNTracker.EXEMPLAR          # 127
INSTANCE = siam.VOT_CFG["instance_size"]         # 271
STRIDE = siam.SiamRPNTracker.STRIDE              # 8
SCORE_SIZE = (INSTANCE - EXEMPLAR) // STRIDE + 1  # 19
NUM_ANCHORS_TOTAL = siam.NUM_ANCHORS * SCORE_SIZE * SCORE_SIZE
NUM_SAMPLES, POSITIVE_FRACTION = 64, 0.25


# ---------------------------------------------------------------------------
# Pair extraction (host): crop geometry mirrors SiamRPNTracker
# ---------------------------------------------------------------------------

def _track_visible_frames(scene: dict, label: int, num_frames: int) -> np.ndarray:
    from objectpermanence_tpu_torch.datagen.perfect_perception import contained_frame_ranges
    spans = contained_frame_ranges(scene).get(label, [])
    visible = np.ones(num_frames, bool)
    for start, end in spans:
        visible[start:end + 1] = False
    return np.flatnonzero(visible)


def _crop_pair(frames, box_t, box_t2, rng) -> Tuple:
    """(template u8 (127, 127, 3), search u8 (271, 271, 3), gt (4,) cx/cy/w/h
    in crop-centred, search-scaled coordinates) for one (t, t + dt) pair of
    frames and xywh boxes; `rng` (a numpy RandomState) jitters the search
    centre."""
    (bx, by, bw, bh), (b2x, b2y, b2w, b2h) = box_t, box_t2
    pos = np.array([bx + bw / 2, by + bh / 2], np.float64)
    sz = np.maximum(np.array([bw, bh], np.float64), 2.0)
    avg = frames[0].mean(axis=(0, 1))

    # template: init()'s context formula
    wc_z = sz[0] + 0.5 * sz.sum()
    hc_z = sz[1] + 0.5 * sz.sum()
    s_z_t = round(np.sqrt(wc_z * hc_z))
    z = siam.get_subwindow(frames[0], pos, int(s_z_t), EXEMPLAR, avg)

    # search: track()'s formula (w/h swap kept) around the PREVIOUS
    # position, jittered to mimic drift
    wc = sz[1] + 0.5 * sz.sum()
    hc = sz[0] + 0.5 * sz.sum()
    s_z = np.sqrt(wc * hc)
    scale_z = EXEMPLAR / s_z
    s_x = int(round(s_z + 2 * ((INSTANCE - EXEMPLAR) / 2) / scale_z))
    center = pos + rng.uniform(-12, 12, size=2)
    x = siam.get_subwindow(frames[1], center, s_x, INSTANCE, avg)

    scale = INSTANCE / s_x
    g_c = np.array([b2x + b2w / 2, b2y + b2h / 2]) - center
    gt = np.array([g_c[0] * scale, g_c[1] * scale,
                   max(b2w, 2.0) * scale, max(b2h, 2.0) * scale], np.float32)
    return z.astype(np.uint8), x.astype(np.uint8), gt


def build_pair_dataset(videos_dir, scenes_dir, labels_dir, out_npz, *,
                       num_pairs: int = 4000, pairs_per_video: int = 4,
                       max_dt: int = 20, seed: int = 0) -> Path:
    """Sample (template, search, gt) crops of any visible object from
    rendered videos into one dense npz (reused when it exists). cv2 decodes
    the videos; it is imported here."""
    import cv2

    from objectpermanence_tpu_torch.datagen.perfect_perception import (
        class_index_for_track, instance_track_name,
    )

    videos_dir, scenes_dir = Path(videos_dir), Path(scenes_dir)
    labels_dir, out_npz = Path(labels_dir), Path(out_npz)
    if out_npz.exists():
        print(f"[siam-data] {out_npz} exists, reusing", flush=True)
        return out_npz

    rng = np.random.RandomState(seed)
    videos = sorted(videos_dir.glob("*.avi"))
    rng.shuffle(videos)
    zs, xs, gts = [], [], []
    t0 = time.time()
    for video_path in videos:
        if len(gts) >= num_pairs:
            break
        name = video_path.stem
        scene = json.loads((scenes_dir / f"{name}.json").read_text())
        gt_bb = json.loads((labels_dir / f"{name}_bb.json").read_text())
        num_frames = len(next(iter(gt_bb.values())))

        cap = cv2.VideoCapture(str(video_path))
        tracks = [(instance_track_name(o), class_index_for_track(instance_track_name(o)))
                  for o in scene["objects"]]
        made = 0
        for _ in range(pairs_per_video * 3):       # rejection budget
            if made >= pairs_per_video or len(gts) >= num_pairs:
                break
            track, label = tracks[rng.randint(len(tracks))]
            visible = _track_visible_frames(scene, label, num_frames)
            if len(visible) < 2:
                continue
            t = int(rng.choice(visible[:-1]))
            later = visible[(visible > t) & (visible <= t + max_dt)]
            if len(later) == 0:
                continue
            t2 = int(rng.choice(later))
            pair_frames = []
            ok = True
            for f in (t, t2):
                cap.set(cv2.CAP_PROP_POS_FRAMES, f)
                ret, frame = cap.read()
                if not ret:
                    ok = False
                    break
                pair_frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if not ok:
                continue
            z, x, gt = _crop_pair(pair_frames, gt_bb[track][t], gt_bb[track][t2], rng)
            zs.append(z)
            xs.append(x)
            gts.append(gt)
            made += 1
        cap.release()
        if len(gts) % 500 < pairs_per_video:
            print(f"[siam-data] {len(gts)}/{num_pairs} pairs ({time.time()-t0:.0f}s)",
                  flush=True)

    out_npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_npz, z=np.stack(zs), x=np.stack(xs), gt=np.stack(gts))
    print(f"[siam-data] wrote {len(gts)} pairs -> {out_npz} ({time.time()-t0:.0f}s)",
          flush=True)
    return out_npz


# ---------------------------------------------------------------------------
# Batched training forward (batch-statistics BN, per-sample correlation)
# ---------------------------------------------------------------------------

def features_train(model: siam.SiamRPN, x: torch.Tensor) -> Tuple[torch.Tensor, List]:
    """`feature_extract` with batch norm on the batch's statistics (biased
    variance) -> (features, [(mean, var)] of the five layers, detached)."""
    stats = []

    def norm(i, bn, y):
        var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
        stats.append((mean.detach(), var.detach()))
        return bn.fold(mean, var, y)

    return model.feature_extract(x, norm), stats


def _correlate(feat: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-correlation as one grouped conv: feat (B, C, H, W)
    with kernels (B, K, C, k, k) -> (B, K, H-k+1, W-k+1)."""
    b, c, h, w = feat.shape
    out = F.conv2d(feat.reshape(1, b * c, h, w), kernels.reshape(-1, c, *kernels.shape[-2:]),
                   groups=b)
    return out.reshape(b, kernels.shape[1], *out.shape[-2:])


def pair_forward_train(model: siam.SiamRPN, z: torch.Tensor, x: torch.Tensor,
                       batch_stats: bool = True):
    """z (B, 3, 127, 127), x (B, 3, 271, 271) float -> (delta (B, 4, Na),
    score logits (B, 2, Na), BN stats): the stats of each layer the mean of
    z's and x's. The flattening is `track_forward`'s channel-major order.
    With `batch_stats` False the frozen running statistics are used and the
    stats are None."""
    batch = z.shape[0]
    if batch_stats:
        z_f, stats_z = features_train(model, z)
        x_f, stats_x = features_train(model, x)
        stats = [((mz + mx) / 2, (vz + vx) / 2)
                 for (mz, vz), (mx, vx) in zip(stats_z, stats_x)]
    else:
        z_f, x_f, stats = model.feature_extract(z), model.feature_extract(x), None
    r1_k, cls1_k = model.template_kernels(z_f)
    delta = model.regress_adjust(_correlate(model.conv_r2(x_f), r1_k))      # (B, 4A, s, s)
    score = _correlate(model.conv_cls2(x_f), cls1_k)                         # (B, 2A, s, s)
    return delta.reshape(batch, 4, -1), score.reshape(batch, 2, -1), stats


# ---------------------------------------------------------------------------
# Loss and train step
# ---------------------------------------------------------------------------

def anchor_arrays(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search map's anchors (Na, 4) as cx/cy/w/h and as xyxy."""
    anchors = siam.generate_anchor(STRIDE, siam.SiamRPNTracker.SCALES,
                                   siam.SiamRPNTracker.RATIOS, SCORE_SIZE)
    cxcywh = torch.from_numpy(anchors).to(device)
    xyxy = torch.stack([cxcywh[:, 0] - cxcywh[:, 2] / 2, cxcywh[:, 1] - cxcywh[:, 3] / 2,
                        cxcywh[:, 0] + cxcywh[:, 2] / 2, cxcywh[:, 1] + cxcywh[:, 3] / 2], -1)
    return cxcywh, xyxy


def _gt_xyxy(gt: torch.Tensor) -> torch.Tensor:
    return torch.stack([gt[:, 0] - gt[:, 2] / 2, gt[:, 1] - gt[:, 3] / 2,
                        gt[:, 0] + gt[:, 2] / 2, gt[:, 1] + gt[:, 3] / 2], -1)


def siam_pair_matches(gt: torch.Tensor, anchors_xyxy: torch.Tensor) -> torch.Tensor:
    """gt (B, 4) cx/cy/w/h -> each anchor's match (B, Na): 0 positive (IoU
    >= 0.6, or the pair's best IoU), BELOW_LOW negative (< 0.3), BETWEEN
    ignored."""
    iou = pairwise_iou_xyxy(_gt_xyxy(gt)[:, None], anchors_xyxy)[:, 0]       # (B, Na)
    matches = torch.where(iou >= 0.6, 0, BETWEEN)
    matches = torch.where(iou < 0.3, BELOW_LOW, matches)
    return torch.where(iou == iou.amax(dim=1, keepdim=True), 0, matches)


def siam_pair_masks(gt: torch.Tensor, anchors_xyxy: torch.Tensor, pos_draws: torch.Tensor,
                    neg_draws: torch.Tensor, num_samples: int = NUM_SAMPLES,
                    positive_fraction: float = POSITIVE_FRACTION):
    """-> (matches, sampled, positive), each (B, Na): the balanced sample of
    `num_samples` anchors, at most `positive_fraction` of them positive,
    ranked by the uniform draws (B, Na)."""
    matches = siam_pair_matches(gt, anchors_xyxy)
    sampled, pos = balanced_sample(matches, num_samples, positive_fraction, pos_draws, neg_draws)
    return matches, sampled, pos


def siam_pair_loss(delta: torch.Tensor, score: torch.Tensor, gt: torch.Tensor,
                   anchors_cxcywh: torch.Tensor, matches: torch.Tensor, sampled: torch.Tensor,
                   pos: torch.Tensor, reg_weight: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each pair's (cls (B,), reg (B,)) loss: the softmax cross-entropy of
    the sampled anchors over their count, and the smooth-L1 (beta 1) of the
    four encoded targets summed, over the positives, over their count."""
    zero = torch.zeros((), dtype=delta.dtype, device=delta.device)
    num_sampled = sampled.sum(dim=1).clamp(min=1)
    num_pos = pos.sum(dim=1).clamp(min=1)
    labels = (matches == 0).long()
    cls = F.cross_entropy(score, labels, reduction="none")                   # (B, Na)
    cls_loss = torch.where(sampled, cls, zero).sum(dim=1) / num_sampled

    a = anchors_cxcywh
    targets = torch.stack([(gt[:, None, 0] - a[:, 0]) / a[:, 2],
                           (gt[:, None, 1] - a[:, 1]) / a[:, 3],
                           torch.log(gt[:, None, 2] / a[:, 2]),
                           torch.log(gt[:, None, 3] / a[:, 3])], dim=1)      # (B, 4, Na)
    reg = smooth_l1(delta - targets, beta=1.0).sum(dim=1)
    reg_loss = torch.where(pos, reg, zero).sum(dim=1) / num_pos
    return cls_loss, reg_weight * reg_loss


def siam_train_init(generator: Optional[torch.Generator] = None,
                    head_scale: float = 0.1) -> siam.SiamRPN:
    """A seeded `SiamRPN` with its four correlation heads' weights scaled by
    `head_scale`: the correlation contracts 256x4x4 unit-scale (post-BN)
    features against kernels of the same scale, so unscaled Kaiming heads
    give |logits| ~ 60-90 at init and the loss diverges."""
    model = siam.SiamRPN(generator)
    with torch.no_grad():
        for name in ("conv_r1", "conv_cls1", "conv_r2", "conv_cls2"):
            getattr(model, name).weight.mul_(head_scale)
    return model


def warmup_cosine_schedule(init_value: float, peak_value: float, warmup_steps: int,
                           decay_steps: int, end_value: float) -> Callable[[int], float]:
    """count -> learning rate of `optax.warmup_cosine_decay_schedule`: linear
    from `init_value` to `peak_value` over `warmup_steps`, then a cosine to
    `end_value` at `decay_steps`, in float32 as optax computes it. Raises, as
    optax does, when no step is left for the cosine."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine needs positive decay steps, got "
                         f"{decay_steps - warmup_steps}")
    f32 = np.float32
    # optax's Python-float constants enter its float32 arithmetic rounded once
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = f32(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        t = min(f32(count - warmup_steps), cosine_steps)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / cosine_steps, dtype=f32))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def make_siam_train_step(optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                         bn_momentum: float = 0.1, max_norm: float = 10.0):
    """-> step(model, z, x, gt, generator=None, masks=None) -> {"loss",
    "cls", "reg"} on the device: the mean over the pairs of each loss part,
    its gradient clipped to a global norm of `max_norm`, the SGD update at
    `schedule(step.count)`, then each layer's running statistics moved
    `bn_momentum` of the way to the batch's. `masks` = (matches, sampled,
    positive) replaces the sample drawn from `generator`."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    cache = {}

    def step(model, z, x, gt, generator: Optional[torch.Generator] = None,
             masks: Optional[Tuple] = None) -> Dict[str, torch.Tensor]:
        if z.device not in cache:
            cache[z.device] = anchor_arrays(z.device)
        anchors_cxcywh, anchors_xyxy = cache[z.device]
        optimizer.zero_grad(set_to_none=False)
        delta, score, stats = pair_forward_train(model, z, x)
        if masks is None:
            shape = (z.shape[0], anchors_xyxy.shape[0])
            masks = siam_pair_masks(gt, anchors_xyxy,
                                    torch.rand(shape, generator=generator, device=z.device),
                                    torch.rand(shape, generator=generator, device=z.device))
        cls_l, reg_l = siam_pair_loss(delta, score, gt, anchors_cxcywh, *masks)
        loss = cls_l.mean() + reg_l.mean()
        loss.backward()
        with torch.no_grad():
            clip_by_global_norm_([p.grad for p in params], max_norm)
            for group in optimizer.param_groups:
                group["lr"] = schedule(step.count)
            optimizer.step()
            step.count += 1
            for (_, bn), (mean, var) in zip(model.feature_layers(), stats):
                bn.running_mean.copy_((1 - bn_momentum) * bn.running_mean + bn_momentum * mean)
                bn.running_var.copy_((1 - bn_momentum) * bn.running_var + bn_momentum * var)
        return {"loss": loss.detach(), "cls": cls_l.mean().detach(),
                "reg": reg_l.mean().detach()}

    step.count = 0
    return step


@torch.no_grad()
def calibrate_batch_norm(model: siam.SiamRPN, z: torch.Tensor, x: torch.Tensor) -> None:
    """Set each feature layer's running statistics to the batch statistics
    of the pairs (z, x), the mean of z's and x's as a train step takes them:
    seeded weights whose frozen-BN forward gives unit-scale features, where
    the init's mean 0, var 1 leave the pixels' scale and saturate the
    scores."""
    _, _, stats = pair_forward_train(model, z, x)
    for (_, bn), (mean, var) in zip(model.feature_layers(), stats):
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)


def make_siam_optimizer(model: siam.SiamRPN, momentum: float = 0.9) -> torch.optim.SGD:
    """optax's `sgd(lr, momentum)` as torch's SGD over the weights and BN
    scales and biases (the learning rate is set by the step)."""
    return torch.optim.SGD(model.parameters(), lr=0.0, momentum=momentum)


@torch.no_grad()
def evaluate_pairs(model: siam.SiamRPN, z, x, gt, batch_size: int = 64) -> Dict[str, float]:
    """Frozen-BN eval: the IoU between the arg-max score anchor's decoded
    box and gt, and the centre-hit rate (< 8 px). z, x are float (N, 3, S, S)
    arrays or tensors (uint8 tensors are cast), gt (N, 4) cx/cy/w/h; the last
    batch is padded with its last pair, as JAX pads to its jit signature."""
    device = next(model.parameters()).device
    anchors_cxcywh, _ = anchor_arrays(device)
    was_training = model.training
    model.eval()
    gt = np.asarray(gt.cpu() if torch.is_tensor(gt) else gt, np.float32)
    n = len(gt)
    ious, hits = [], []
    for start in range(0, n, batch_size):
        zb = torch.as_tensor(z[start:start + batch_size]).to(device).float()
        xb = torch.as_tensor(x[start:start + batch_size]).to(device).float()
        gb = gt[start:start + batch_size]
        if len(zb) < batch_size:
            pad = batch_size - len(zb)
            zb = torch.cat([zb, zb[-1:].expand(pad, *zb.shape[1:])])
            xb = torch.cat([xb, xb[-1:].expand(pad, *xb.shape[1:])])
        delta, score, _ = pair_forward_train(model, zb, xb, batch_stats=False)
        score = torch.softmax(score, dim=1)[:, 1]
        best = score.argmax(dim=-1)
        d = torch.gather(delta, 2, best[:, None, None].expand(-1, 4, 1))[..., 0]
        a = anchors_cxcywh[best]
        pred = torch.stack([d[:, 0] * a[:, 2] + a[:, 0], d[:, 1] * a[:, 3] + a[:, 1],
                            torch.exp(torch.clamp(d[:, 2], max=20.0)) * a[:, 2],
                            torch.exp(torch.clamp(d[:, 3], max=20.0)) * a[:, 3]], -1)
        pred = pred.cpu().numpy()[:len(gb)]
        p_xyxy = np.stack([pred[:, 0] - pred[:, 2] / 2, pred[:, 1] - pred[:, 3] / 2,
                           pred[:, 0] + pred[:, 2] / 2, pred[:, 1] + pred[:, 3] / 2], axis=-1)
        g_xyxy = np.stack([gb[:, 0] - gb[:, 2] / 2, gb[:, 1] - gb[:, 3] / 2,
                           gb[:, 0] + gb[:, 2] / 2, gb[:, 1] + gb[:, 3] / 2], axis=-1)
        lt = np.maximum(p_xyxy[:, :2], g_xyxy[:, :2])
        rb = np.minimum(p_xyxy[:, 2:], g_xyxy[:, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
        area_p = np.prod(p_xyxy[:, 2:] - p_xyxy[:, :2], axis=-1)
        area_g = np.prod(g_xyxy[:, 2:] - g_xyxy[:, :2], axis=-1)
        ious.append(inter / np.maximum(area_p + area_g - inter, 1e-9))
        hits.append(np.hypot(pred[:, 0] - gb[:, 0], pred[:, 1] - gb[:, 1]) < 8.0)
    model.train(was_training)
    return {"mean_iou": float(np.mean(np.concatenate(ious))),
            "center_hit": float(np.mean(np.concatenate(hits)))}


def siam_train_main(pairs_npz, checkpoint_dir, *, num_epochs: int = 30,
                    batch_size: int = 32, learning_rate: float = 5e-3,
                    momentum: float = 0.9, holdout: int = 256,
                    seed: int = 0, print_step: int = 50, device=None) -> Dict:
    """Train on a pair npz (`build_pair_dataset`'s) on `device` (the card
    unless "cpu"); the first `holdout` pairs are held out and evaluated after
    each epoch. Writes `checkpoint_dir/final.npz` (`build_siam_reasoner`
    loads it, or the directory). -> {"model", "history", "checkpoint"}."""
    from objectpermanence_tpu_torch.utils import checkpoint as ckpt

    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    with np.load(pairs_npz) as blob:
        z_all = np.ascontiguousarray(blob["z"].transpose(0, 3, 1, 2))
        x_all = np.ascontiguousarray(blob["x"].transpose(0, 3, 1, 2))
        gt_all = blob["gt"].astype(np.float32)
    z_val, x_val, gt_val = (a[:holdout] for a in (z_all, x_all, gt_all))
    # uint8 on the device, cast per batch: the values JAX's float32 copy holds
    z_d, x_d, gt_d = (torch.from_numpy(a[holdout:]).to(device) for a in (z_all, x_all, gt_all))
    num = len(gt_d)
    print(f"[siam-train] {num} train / {len(gt_val)} holdout pairs", flush=True)

    model = siam_train_init(torch.Generator().manual_seed(seed)).to(device).train()
    # cosine decay like modern SiamRPN recipes; warmup one epoch
    steps_per_epoch = max(num // batch_size, 1)
    schedule = warmup_cosine_schedule(0.0, learning_rate, steps_per_epoch,
                                      num_epochs * steps_per_epoch, learning_rate * 0.01)
    train_step = make_siam_train_step(make_siam_optimizer(model, momentum), schedule)

    rng = np.random.RandomState(seed)
    generator = torch.Generator(device).manual_seed(seed + 1)
    history = []
    t0 = time.time()
    for epoch in range(num_epochs):
        order = rng.permutation(num)
        for it in range(steps_per_epoch):
            idx = torch.from_numpy(order[it * batch_size:(it + 1) * batch_size]).to(device)
            metrics = train_step(model, z_d[idx].float(), x_d[idx].float(), gt_d[idx],
                                 generator)
            if (it + 1) % print_step == 0:
                print(f"[siam-train] epoch {epoch+1} it {it+1}: "
                      f"{ {k: float(v) for k, v in metrics.items()} } ({time.time()-t0:.0f}s)",
                      flush=True)
        # frozen BN scores each pair alone, so a batch no larger than the
        # holdout gives JAX's numbers without its padding to 64
        ev = evaluate_pairs(model, z_val, x_val, gt_val, batch_size=min(64, max(holdout, 1)))
        print(f"[siam-train] epoch {epoch+1}: holdout {ev}", flush=True)
        history.append({"epoch": epoch + 1, **ev})

    final = ckpt.save_params(Path(checkpoint_dir) / "final.npz", model.state_dict())
    return {"model": model, "history": history, "checkpoint": str(final)}
