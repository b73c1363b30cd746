"""Fixed-shape keypoint extraction, batched over views.

Port of `relativepose_tpu/match/keypoints.py`:

  * `detect_dog`: multi-scale difference-of-Gaussians corners with 3x3
    NMS and top-K selection (edge-replicate padding), on the observed
    face, or for ScanNet on the 480x640 frame remapped into the kinect
    window;
  * `augment_with_feature_matches`: top-2-with-NMS locations of query
    descriptors in the other view's descriptor map;
  * `random_unobserved_points`: uniform pano points outside the observed
    region;
  * `build_keypoint_sets`: the per-view fixed-capacity keypoint sets with
    observation weights 1.0 / 0.99.

Randomness: where the JAX package draws from `jax.random.choice(p=...)` or
`jax.random.uniform`, these functions take the draws as tensor arguments
(`KeypointDraws`); `draw_keypoints` alone makes them, from a
`torch.Generator`.  A test hands both packages the same draws.

Ties: `lax.top_k` puts equal values in index order; the port selects with
a stable descending sort, which gives the same order.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from relativepose_tpu_torch import config
from relativepose_tpu_torch.ops.interpolate import interpolate_normalized
from relativepose_tpu_torch.ops.sampling import topk_nms

FACE = config.FACE
H, W = config.PANO_HEIGHT, config.PANO_WIDTH

N_SIFT_MATCH = 30
N_RANDOM = 30
# the original's kinect count; like the JAX package, nothing uses it: the
# kinect path draws `KeypointConfig.n_random` points too
N_RANDOM_KINECT = 120
MARKER = 0.99
AUG_TOPK = 2


@dataclasses.dataclass(frozen=True)
class KeypointConfig:
    n_detect: int = 224       # detector capacity per view
    dog_threshold: float = 2.0  # on 0..255 luma DoG response
    n_match: int = N_SIFT_MATCH
    n_random: int = N_RANDOM

    @property
    def capacity(self) -> int:
        # detected + 2*n_match aug + max(n_random, 2*n_random aug)
        return self.n_detect + 2 * self.n_match + 2 * self.n_random


@dataclasses.dataclass
class KeypointDraws:
    """The random draws of one `build_keypoint_sets` call, per pair.

    sel_t1: [B, n_match] indices of source detections used as queries in
    the target map; sel_s: [B, n_match] target detections queried in the
    source map; rnd_u: [B, 2, n_random] uniforms in [0, 1) for the random
    unobserved source points (x row, then y row); sel_t2: [B, n_random]
    random source points queried in the target map.  In the JAX package
    these come from keys 0, 1, 2 and 3 of `jax.random.split(key, 6)`.
    """

    sel_t1: torch.Tensor
    sel_s: torch.Tensor
    rnd_u: torch.Tensor
    sel_t2: torch.Tensor


def topk_stable(x, k: int):
    """Top-k over the last axis, equal values in index order (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rgb_to_gray(rgb):
    """BGR (0..255) -> gray luma like cv2.cvtColor(BGR2GRAY)."""
    b, g, r = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r


@functools.lru_cache(maxsize=None)
def _gauss_taps(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _separable(img, kv, kh, radius, groups):
    """Edge-replicate pad img [N, h, w], then a vertical and a horizontal
    1-D correlation.  kv: [S, 1, 2r+1, 1]; kh: [S, 1, 1, 2r+1]."""
    x = F.pad(img[:, None], (radius, radius, radius, radius), mode="replicate")
    x = F.conv2d(x, kv)
    return F.conv2d(x, kh, groups=groups)


def _blur(img, sigma, radius=None):
    """Separable gaussian blur of img [..., h, w], edge-replicate padding."""
    radius = radius or max(1, int(3 * sigma + 0.5))
    taps = torch.from_numpy(_gauss_taps(float(sigma), radius)).to(img.device)
    lead, (h, w) = img.shape[:-2], img.shape[-2:]
    y = _separable(img.reshape(-1, h, w), taps.reshape(1, 1, -1, 1),
                   taps.reshape(1, 1, 1, -1), radius, 1)
    return y[:, 0].reshape(lead + (h, w))


@functools.lru_cache(maxsize=None)
def _scale_stack_taps(sigmas):
    """(radius, [S, 2r+1] taps): each row a sigma's normalized taps,
    zero-padded to the shared radius."""
    radius = max(max(1, int(3 * s + 0.5)) for s in sigmas)
    rows = []
    for s in sigmas:
        r = max(1, int(3 * s + 0.5))
        taps = np.zeros(2 * radius + 1, np.float32)
        taps[radius - r: radius + r + 1] = _gauss_taps(float(s), r)
        rows.append(taps)
    return radius, np.stack(rows, 0)


def _blur_scales(img, sigmas):
    """All-scale gaussian stack of img [N, h, w] -> [N, S, h, w]."""
    radius, taps = _scale_stack_taps(tuple(float(s) for s in sigmas))
    taps = torch.from_numpy(taps).to(img.device)
    s = taps.shape[0]
    return _separable(img, taps.reshape(s, 1, -1, 1),
                      taps.reshape(s, 1, 1, -1), radius, s)


def detect_dog(gray, k_det: int, threshold: float = 2.0):
    """Multi-scale DoG corners on grayscale images [..., h, w].

    Returns (pts [..., k_det, 2] float (x, y), valid [..., k_det] bool),
    strongest first; the 1-px border is excluded.
    """
    lead, (h, w) = gray.shape[:-2], gray.shape[-2:]
    stack = _blur_scales(gray.reshape(-1, h, w), (1.0, 1.6, 2.56, 4.1))
    resp = torch.amax(torch.abs(stack[:, 1:] - stack[:, :-1]), dim=1)
    pooled = F.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]
    is_peak = (resp >= pooled) & (resp > threshold)
    border = torch.zeros((h, w), dtype=torch.bool, device=gray.device)
    border[1:-1, 1:-1] = True
    score = torch.where(is_peak & border, resp, -1.0)
    flat_scores, flat_idx = topk_stable(score.reshape(score.shape[0], -1),
                                        k_det)
    ys = torch.div(flat_idx, w, rounding_mode="floor").to(torch.float32)
    xs = (flat_idx % w).to(torch.float32)
    pts = torch.stack([xs, ys], dim=-1)
    return pts.reshape(lead + (k_det, 2)), (flat_scores > 0).reshape(
        lead + (k_det,))


def _take(x, idx):
    """x [B, K, ...] rows at idx [B, n] -> [B, n, ...]."""
    idx = idx.long()
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def _select_queries(desc, valid, sel):
    """The query descriptors desc [B, K, F] and their valid [B, K] flags
    at the drawn indices sel [B, n] (`_draw_indices`)."""
    return _take(desc, sel), _take(valid, sel)


def _draw_indices(valid, n, generator=None):
    """[B, n] indices drawn with probability proportional to valid + 1e-9
    (`jax.random.choice(p=...)` in the JAX package)."""
    probs = valid.to(torch.float32) + 1e-9
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.multinomial(probs, n, replacement=True, generator=generator)


def _distance_heatmaps(q, feat):
    """Squared-distance heatmaps [B, n, H, W] of queries q [B, n, F]
    against dense maps feat [B, H, W, F]: |q|^2 - 2 q.f + |f|^2."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    d = (
        torch.sum(q * q, -1, keepdim=True)
        - (2.0 * q) @ flat.transpose(1, 2)
        + torch.sum(flat * flat, -1)[:, None, :]
    )
    return d.reshape(b, q.shape[1], h, w)


def _nms_to_keypoints(d, sel_valid, hw):
    """Top-2-with-NMS locations per heatmap [B, n, H, W] -> keypoints."""
    h, w = hw
    b = d.shape[0]
    pts = topk_nms(d, AUG_TOPK).reshape(b, -1, 2).to(torch.float32)
    valid = (pts[..., 0] < w - 1) & (pts[..., 1] < h - 1)
    return pts, valid & torch.repeat_interleave(sel_valid, AUG_TOPK, dim=1)


def augment_with_feature_matches(desc_query, query_valid, feat_other, sel):
    """Query descriptors [B, K, F] of one view, picked at the drawn
    indices sel [B, n_match], matched in the OTHER view's map
    [B, H, W, F]: (pts [B, 2*n_match, 2], valid)."""
    q, sel_valid = _select_queries(desc_query, query_valid, sel)
    d = _distance_heatmaps(q, feat_other)
    return _nms_to_keypoints(d, sel_valid, feat_other.shape[1:3])


def in_observed_region(pts, mask_method: str):
    """Observation test for keypoint weights. pts: [..., 2] (x, y)."""
    x, y = pts[..., 0], pts[..., 1]
    if mask_method == "second":
        return (x >= FACE) & (x <= 2 * FACE)
    if mask_method == "kinect":
        return ((x >= config.KINECT_COL0) & (x <= config.KINECT_COL1)
                & (y >= config.KINECT_ROW0) & (y <= config.KINECT_ROW1))
    raise ValueError(mask_method)


def random_unobserved_points(u, mask_method: str):
    """Uniform pano points outside the observed region, per pair.

    u: [B, 2, n_random] uniforms in [0, 1) (x row, y row).  Returns
    (pts [B, n_random, 2], valid)."""
    xs = torch.clamp((u[:, 0] * W).to(torch.int32), 0, W - 2)
    ys = torch.clamp((u[:, 1] * H).to(torch.int32), 0, H - 2)
    pts = torch.stack([xs, ys], dim=-1).to(torch.float32)
    return pts, ~in_observed_region(pts, mask_method)


def _normalized(pts):
    return pts / torch.tensor([W, H], dtype=pts.dtype, device=pts.device)


def draw_keypoints(det_s_valid, det_t_valid, cfg: KeypointConfig,
                   mask_method: str = "second",
                   generator=None) -> KeypointDraws:
    """All the draws of one `build_keypoint_sets` call, made from
    `generator`.  det_*_valid: [B, n_detect] detection masks
    (`detect_observed`)."""
    b = det_s_valid.shape[0]
    sel_t1 = _draw_indices(det_s_valid, cfg.n_match, generator)
    sel_s = _draw_indices(det_t_valid, cfg.n_match, generator)
    rnd_u = torch.rand((b, 2, cfg.n_random), generator=generator,
                       device=det_s_valid.device)
    _, rnd_valid = random_unobserved_points(rnd_u, mask_method)
    sel_t2 = _draw_indices(rnd_valid, cfg.n_random, generator)
    return KeypointDraws(sel_t1, sel_s, rnd_u, sel_t2)


def detect_observed(rgb, cfg: KeypointConfig, gray_full=None):
    """Step-invariant DoG detection on the observed region.

    rgb: [B, H, W, 3] masked BGR 0..255.  For ScanNet pass gray_full
    [B, 480, 640]: detection runs on the full frame and is remapped into
    the kinect window.  Returns (pts [B, n_detect, 2] pano coords, valid
    [B, n_detect])."""
    if gray_full is not None:
        pts, valid = detect_dog(gray_full, cfg.n_detect, cfg.dog_threshold)
        # divided by a tensor: CUDA turns a division by a Python number
        # into a product with its rounded reciprocal, one ulp off
        full = torch.tensor([config.KINECT_FULL_W, config.KINECT_FULL_H],
                            dtype=pts.dtype, device=pts.device)
        win = torch.tensor([config.KINECT_FOV_W, config.KINECT_FOV_H],
                           dtype=pts.dtype, device=pts.device)
        off = torch.tensor([config.KINECT_COL0, config.KINECT_ROW0],
                           dtype=pts.dtype, device=pts.device)
        return pts / full * win + off, valid
    obs = rgb_to_gray(rgb)[..., :, FACE: 2 * FACE]
    pts, valid = detect_dog(obs, cfg.n_detect, cfg.dog_threshold)
    return pts + torch.tensor([FACE, 0.0], device=pts.device), valid


def build_keypoint_sets(rgb_s, rgb_t, feat_s, feat_t, cfg: KeypointConfig,
                        mask_method: str = "second", gray_full_s=None,
                        gray_full_t=None, det_s=None, det_t=None,
                        draws: Optional[KeypointDraws] = None,
                        generator=None):
    """Per-view keypoint sets for a batch of pairs.

    rgb_s/rgb_t: [B, H, W, 3] masked BGR 0..255; feat_s/feat_t:
    [B, H, W, F] descriptor maps; gray_full_s/t: [B, 480, 640] ScanNet
    frames (see `detect_observed`); det_s/det_t: optional
    `detect_observed` results; draws: `KeypointDraws`, made from
    `generator` by `draw_keypoints` when absent.  Returns (pts_s,
    valid_s, w_s, pts_t, valid_t, w_t) with pts [B, capacity, 2] float
    pano coords and w 1.0 observed / 0.99 outside.
    """
    if feat_s.shape[1:3] != feat_t.shape[1:3]:
        raise ValueError(f"view shapes differ: {feat_s.shape} {feat_t.shape}")
    if det_s is None:
        det_s = detect_observed(rgb_s, cfg, gray_full_s)
    if det_t is None:
        det_t = detect_observed(rgb_t, cfg, gray_full_t)
    det_s, det_s_valid = det_s
    det_t, det_t_valid = det_t
    if draws is None:
        draws = draw_keypoints(det_s_valid, det_t_valid, cfg, mask_method,
                               generator)

    desc_s = interpolate_normalized(feat_s, _normalized(det_s))
    desc_t = interpolate_normalized(feat_t, _normalized(det_t))

    # both augmentation directions and the random-point matches go
    # through one concatenated heatmap stack and one topk_nms, as in the
    # JAX package
    q_t1, q_t1_valid = _select_queries(desc_s, det_s_valid, draws.sel_t1)
    q_s, q_s_valid = _select_queries(desc_t, det_t_valid, draws.sel_s)
    rnd_s, rnd_s_valid = random_unobserved_points(draws.rnd_u, mask_method)
    desc_rnd = interpolate_normalized(feat_s, _normalized(rnd_s))
    q_t2, q_t2_valid = _select_queries(desc_rnd, rnd_s_valid, draws.sel_t2)

    d_t = _distance_heatmaps(torch.cat([q_t1, q_t2], 1), feat_t)
    d_s = _distance_heatmaps(q_s, feat_s)
    pts_all, valid_all = _nms_to_keypoints(
        torch.cat([d_t, d_s], 1),
        torch.cat([q_t1_valid, q_t2_valid, q_s_valid], 1),
        feat_t.shape[1:3])
    n_t1 = AUG_TOPK * cfg.n_match
    n_t2 = AUG_TOPK * cfg.n_random

    cap = cfg.capacity
    pts_s = torch.cat([det_s, pts_all[:, n_t1 + n_t2:], rnd_s], 1)
    valid_s = torch.cat(
        [det_s_valid, valid_all[:, n_t1 + n_t2:], rnd_s_valid], 1)
    pad = cap - pts_s.shape[1]
    pts_s = F.pad(pts_s, (0, 0, 0, pad))
    valid_s = F.pad(valid_s, (0, pad))

    pts_t = torch.cat([det_t, pts_all[:, :n_t1 + n_t2]], 1)
    valid_t = torch.cat([det_t_valid, valid_all[:, :n_t1 + n_t2]], 1)
    pad = cap - pts_t.shape[1]
    pts_t = F.pad(pts_t, (0, 0, 0, pad))
    valid_t = F.pad(valid_t, (0, pad))

    one = torch.ones((), device=pts_s.device)
    w_s = torch.where(in_observed_region(pts_s, mask_method), one, MARKER)
    w_t = torch.where(in_observed_region(pts_t, mask_method), one, MARKER)
    return pts_s, valid_s, w_s, pts_t, valid_t, w_t
