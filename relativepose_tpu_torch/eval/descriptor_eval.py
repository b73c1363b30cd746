"""Descriptor-quality evaluation: ranking ratios of learned descriptors.

Port of `relativepose_tpu/eval/descriptor_eval.py`: for each ground-truth
correspondence, the fraction of target locations whose descriptor is
closer to the source descriptor than the true match's is (0 is perfect),
split by whether the correspondence's endpoints lie in the observed
region.  Batched over pairs; the sampled correspondence indices are a
tensor argument (drawn from a `torch.Generator` when absent), so that a
test can hand both packages the same samples.  `sift_ranking_ratio`, the
classical comparison curve, runs on the host with OpenCV, imported when
called.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_indices(n: int, k: int, sample: int, generator=None,
                   device="cuda"):
    """[n, sample] correspondence indices, uniform in [0, k)."""
    return torch.randint(0, k, (n, sample), generator=generator,
                         device=device)


def _at(x, idx):
    """x [n, H, W, ...] at the (x, y) pixels idx [n, S, 2] -> [n, S, ...]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    idx = idx.long()
    return x[b, idx[..., 1], idx[..., 0]]


def _take(idx, sel):
    """The sampled rows sel [n, S] of idx [n, K, 2]."""
    sel = sel.long()
    return torch.gather(idx, 1, sel[..., None].expand(sel.shape + (2,)))


def ranking_ratio(feat_s, feat_t, idx_src, idx_tgt, valid, sample=100,
                  sel=None, generator=None):
    """feat_s/feat_t: [n, H, W, C]; idx_src/idx_tgt: [n, K, 2] (x, y);
    valid: [n]; sel: [n, sample] sampled correspondence indices
    (`sample_indices` from `generator` when absent).  For each sample,
    ratio = #{locations with d(f_s, f_t[loc]) < d(f_s, f_t[match])} /
    (H*W).  Returns (ratios [n, sample], valid)."""
    n, h, w, c = feat_t.shape
    if sel is None:
        sel = sample_indices(n, idx_src.shape[1], sample, generator,
                             feat_t.device)
    fs = _at(feat_s, _take(idx_src, sel))       # [n, S, C]
    ft = _at(feat_t, _take(idx_tgt, sel))
    true_d2 = torch.sum((fs - ft) ** 2, -1)      # [n, S]
    flat_t = feat_t.reshape(n, h * w, c)
    d2_all = (torch.sum(fs * fs, -1, keepdim=True)
              - 2.0 * (fs @ flat_t.transpose(1, 2))
              + torch.sum(flat_t * flat_t, -1)[:, None, :])
    ratios = torch.mean((d2_all < true_d2[..., None]).to(torch.float32),
                        dim=-1)
    return ratios, valid


def sift_ranking_ratio(rgb_s, rgb_t, idx_src, idx_tgt, valid, sample=100,
                       step_size=5, seed=0):
    """Classical-SIFT ranking ratios on the host (OpenCV).

    For each valid pair, `sample` ground-truth correspondences drawn with
    `np.random.RandomState(seed)`; SIFT descriptors (keypoint size
    step_size) at the source and target points and on a dense
    step_size-pixel grid over the target; ratio = fraction of grid
    locations closer to the source descriptor than the true match's.
    SIFT may drop keypoints (image borders), so only correspondences whose
    keypoints survive in both views are kept, matched by coordinates.

    rgb_s/rgb_t: [n, H, W, 3] BGR in [0, 1] (numpy); idx_*: [n, K, 2]
    (x, y); valid: [n].  Returns a list of per-pair mean ratios."""
    import cv2

    sift = cv2.SIFT_create(contrastThreshold=0.02)
    rng = np.random.RandomState(seed)
    n, h, w = rgb_s.shape[0], rgb_s.shape[1], rgb_s.shape[2]
    grid_kp = [cv2.KeyPoint(float(x), float(y), step_size)
               for y in range(0, h, step_size)
               for x in range(0, w, step_size)]

    def surviving(kp_in, kp_out):
        pos = {(round(k.pt[0], 2), round(k.pt[1], 2)): i
               for i, k in enumerate(kp_out)}
        return {j: pos[key] for j, k in enumerate(kp_in)
                if (key := (round(k.pt[0], 2), round(k.pt[1], 2))) in pos}

    ratios = []
    for j in range(n):
        if not bool(valid[j]):
            continue
        sel = rng.choice(idx_src.shape[1], sample)
        gray_s = cv2.cvtColor((np.asarray(rgb_s[j]) * 255).astype(np.uint8),
                              cv2.COLOR_BGR2GRAY)
        gray_t = cv2.cvtColor((np.asarray(rgb_t[j]) * 255).astype(np.uint8),
                              cv2.COLOR_BGR2GRAY)
        kp_s = [cv2.KeyPoint(float(c[0]), float(c[1]), step_size)
                for c in np.asarray(idx_src[j])[sel]]
        kp_t = [cv2.KeyPoint(float(c[0]), float(c[1]), step_size)
                for c in np.asarray(idx_tgt[j])[sel]]
        kp_s_out, d_s = sift.compute(gray_s, kp_s)
        kp_t_out, d_t = sift.compute(gray_t, kp_t)
        live_s = surviving(kp_s, kp_s_out or [])
        live_t = surviving(kp_t, kp_t_out or [])
        both = sorted(set(live_s) & set(live_t))
        if not both:
            continue
        d_s = d_s[[live_s[i] for i in both]]
        d_t = d_t[[live_t[i] for i in both]]
        _, d_grid = sift.compute(gray_t, list(grid_kp))
        true_d2 = np.power(d_s - d_t, 2).sum(1)
        rest = np.power(d_s[:, None, :] - d_grid[None, :, :], 2).sum(2)
        ratio = (rest < true_d2[:, None]).sum(1) / rest.shape[1]
        ratios.append(float(ratio.mean()))
    return ratios


def observe_type(mask, idx_src, idx_tgt):
    """Observation class of correspondences: 2 = both endpoints observed,
    1 = one, 0 = none.  mask: [n, H, W]; idx_*: [n, S, 2] (x, y)."""
    return _at(mask, idx_src) + _at(mask, idx_tgt)


def bucketed_ratios(feat_s, feat_t, dense, mask, sample=100, sel=None,
                    generator=None):
    """Ranking ratios split into observed (both endpoints) and unobserved
    buckets, over the valid pairs: dict(obs=[...], unobs=[...]) of host
    floats.  dense: 'idx_src', 'idx_tgt' [n, K, 2], 'valid' [n]; sel as in
    `ranking_ratio`, drawn once for both."""
    n, k = dense["idx_src"].shape[:2]
    if sel is None:
        sel = sample_indices(n, k, sample, generator, feat_t.device)
    ratios, _ = ranking_ratio(feat_s, feat_t, dense["idx_src"],
                              dense["idx_tgt"], dense["valid"], sel=sel)
    obs = observe_type(mask, _take(dense["idx_src"], sel),
                       _take(dense["idx_tgt"], sel))
    ratios = ratios.cpu().numpy()
    obs = obs.cpu().numpy()
    valid = np.asarray(torch.as_tensor(dense["valid"]).cpu()).astype(bool)
    out = {"obs": [], "unobs": []}
    for i in range(n):
        if valid[i]:
            out["obs"].extend(ratios[i][obs[i] == 2].tolist())
            out["unobs"].extend(ratios[i][obs[i] < 2].tolist())
    return out
