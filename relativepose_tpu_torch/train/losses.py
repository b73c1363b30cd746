"""Training losses, batched and mask-weighted.

Port of `relativepose_tpu/train/losses.py`: the contrastive correspondence
loss (uniform or hard-mined negatives), masked L1, weighted cross-entropy,
the feature-consistency loss and the plane-normal-depth loss.  NHWC
feature maps.

The negative draws are tensors passed in (`draw_negatives` makes them from
a torch generator), so a test can hand the JAX package's draws to both.
Features enter the distance computations in f32, whatever the network's
compute dtype: the losses' distance products stay f32 (TF32 off, see
`pipeline/recurrent.py::set_numerics`).

Every loss takes a `group`: in data-parallel training (`train/mesh.py`)
its sums and counts are reduced over that process group, so each rank's
value is the global batch's loss.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from relativepose_tpu_torch import config
from relativepose_tpu_torch.core import skybox
from relativepose_tpu_torch.train import mesh
from relativepose_tpu_torch.match.keypoints import topk_stable

_EPS = 1e-12


class NegativeDraws(NamedTuple):
    """Negative pixel rows and columns: [n, K, n_neg] for uniform
    negatives, [n, n_candidates] for the hard-mining candidate pool."""
    y: torch.Tensor
    x: torch.Tensor


def _sum(x, group):
    return mesh.global_sum(torch.sum(x), group)


def _mean(x, group):
    if group is None:
        return torch.mean(x)
    return _sum(x, group) / (x.numel() * mesh.group_size(group))


def draw_negatives(n: int, k: int, h: int, w: int, hard_negatives: bool,
                   n_neg: int = 100, n_candidates: int = 1024,
                   generator=None, device="cuda") -> NegativeDraws:
    """Uniform pixel draws for `contrastive_loss`."""
    shape = (n, n_candidates) if hard_negatives else (n, k, n_neg)
    y = torch.randint(0, h, shape, generator=generator, device=device)
    x = torch.randint(0, w, shape, generator=generator, device=device)
    return NegativeDraws(y, x)


def _gather_feat(feat, idx):
    """feat: [n, H, W, C]; idx: [n, K, 2] (x, y) float -> [n, K, C].
    Integer lookup by truncation toward zero, as `.astype(int32)`."""
    n = feat.shape[0]
    x = idx[..., 0].to(torch.int64)
    y = idx[..., 1].to(torch.int64)
    b = torch.arange(n, device=feat.device)[:, None]
    return feat[b, y, x]


def contrastive_loss(feat_s, feat_t, dense, negatives: NegativeDraws,
                     margin: float = 0.5, n_neg: int = 100,
                     hard_negatives: bool = False,
                     exclude_radius: float = 8.0, group=None):
    """Contrastive correspondence loss.

    feat_s/feat_t: [n, H, W, C]; dense: dict(idx_src [n, K, 2],
    idx_tgt [n, K, 2], valid [n]).  Returns (loss, pos, neg): means over
    valid samples only (zero when no sample is valid).

    Uniform negatives: the hinge relu(margin - d^2) over the `n_neg`
    drawn target pixels of each anchor.  Hard negatives: over the `n_neg`
    smallest distances to a shared candidate pool per sample, excluding
    candidates within `exclude_radius` pixels of the true match.
    """
    feat_s = feat_s.float()
    feat_t = feat_t.float()
    k = dense["idx_src"].shape[1]
    valid = dense["valid"].to(feat_s.dtype)
    n_valid = _sum(valid, group)

    fs = _gather_feat(feat_s, dense["idx_src"])
    ft = _gather_feat(feat_t, dense["idx_tgt"])
    pos_d2 = torch.sum((fs - ft) ** 2, dim=-1)
    loss_pos = _sum(pos_d2 * valid[:, None], group) / (n_valid * k + _EPS)

    b = torch.arange(feat_t.shape[0], device=feat_t.device)
    if not hard_negatives:
        f_neg = feat_t[b[:, None, None], negatives.y, negatives.x]
        neg_d2 = torch.sum((fs[:, :, None, :] - f_neg) ** 2, dim=-1)
        hinge = torch.clamp(margin - neg_d2, min=0.0)
        loss_neg = _sum(hinge * valid[:, None, None], group) / (
            n_valid * k * n_neg + _EPS)
        return loss_pos + loss_neg, loss_pos, loss_neg

    cand_y, cand_x = negatives
    f_cand = feat_t[b[:, None], cand_y, cand_x]  # [n, P, C]
    d2 = (torch.sum(fs * fs, dim=-1, keepdim=True)
          - 2.0 * (fs @ f_cand.transpose(1, 2))
          + torch.sum(f_cand * f_cand, dim=-1)[:, None, :])
    tgt = dense["idx_tgt"]
    dx = cand_x[:, None, :].to(tgt.dtype) - tgt[..., 0][..., None]
    dy = cand_y[:, None, :].to(tgt.dtype) - tgt[..., 1][..., None]
    near = (dx * dx + dy * dy) < exclude_radius ** 2
    d2 = torch.where(near, torch.inf, d2)
    neg_d2, _ = topk_stable(-d2, n_neg)
    neg_d2 = -neg_d2
    hinge = torch.where(torch.isfinite(neg_d2),
                        torch.clamp(margin - neg_d2, min=0.0), 0.0)
    loss_neg = _sum(hinge * valid[:, None, None], group) / (
        n_valid * k * n_neg + _EPS)
    return loss_pos + loss_neg, loss_pos, loss_neg


def masked_l1(pred, target, weight, group=None):
    """mean(|pred - target| * weight) over all elements."""
    return _mean(torch.abs(pred.float() - target) * weight, group)


def weighted_ce(logits, labels, weight, scale: float = 0.1, group=None):
    """Per-pixel cross-entropy * weight, mean over all pixels, x scale."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _mean(ce * weight[..., 0], group) * scale


def feature_consistency_loss(f_pred, f_teacher, data_mask, geow,
                             group=None):
    """||(f_pred - f_teacher) * dataMask * geow||^2 summed over channels,
    mean over pixels; no gradient reaches the teacher."""
    d = (f_pred.float() - f_teacher.detach().float()) * data_mask * geow
    return _mean(torch.sum(d * d, dim=-1), group)


def plane_normal_loss(depth_gt, normal_pred, plane_pred, dataset: str,
                      scale: float = 0.1, group=None):
    """Plane-normal-depth consistency, masked.

    depth_gt: [n, H, W]; normal_pred: [n, H, W, 3]; plane_pred: [n, H, W]
    (the completion step feeds pred_depth * 4).  Per skybox face, the
    point where the pixel ray meets the predicted plane should match the
    point lifted from depth_gt."""
    ds = config.canonical_dataset(dataset)
    if ds == "scannet":
        raise NotImplementedError("scannet/skybox pnloss unsupported")
    normal_pred = normal_pred.float()
    plane_pred = plane_pred.float()
    dev = normal_pred.device
    rots = skybox.face_rotations(ds, torch.float32, dev)
    F_ = config.FACE
    ys, xs = np.meshgrid(range(F_), range(F_), indexing="ij")
    xs = torch.from_numpy(((xs / F_ - 0.5) * 2.0).reshape(-1).astype(
        np.float32)).to(dev)
    ys = torch.from_numpy(((0.5 - ys / F_) * 2.0).reshape(-1).astype(
        np.float32)).to(dev)
    ray = torch.stack([-xs, -ys, torch.ones_like(xs)], dim=-1)
    n = plane_pred.shape[0]
    total = 0.0
    for j in range(4):
        blk = slice(j * F_, (j + 1) * F_)
        z = plane_pred[:, :, blk].reshape(n, -1)
        mask = (z != 0).float()
        n_face = normal_pred[:, :, blk].reshape(n, -1, 3) @ rots[j]
        denom = torch.sum(ray[None] * n_face, dim=-1) + 1e-6
        pc_pn = (z / denom)[..., None] * ray[None]
        zd = depth_gt[:, :, blk].reshape(n, -1)
        pc_d = torch.stack([xs[None] * zd, ys[None] * zd, -zd], dim=-1)
        diff = torch.clamp(pc_d - pc_pn, -5.0, 5.0)
        total = total + _mean(torch.abs(diff) * mask[..., None], group)
    return total * scale
