"""Pairwise-consistency pose solver (irls+sm / spectral / irls / horn87).

Port of `relativepose_tpu/match/solver.py`, batched over a leading pair
dimension.  Every quantity the original RelativePose solver computes over
correspondence pairs factorizes through one symmetric pair-weight matrix
W [C, C]: Horn sums reduce to row sums, IRLS factors stay per
correspondence, and the spectral matrix A = W o (h (+) h) is two matvecs.
So a solve is: build W once (the CUDA kernel `ops.kernels.
pair_weight_matrix` when `pallas_w_build`, as on the TPU), then a fixed
schedule of row sums, 4x4 Horn eigensolves and power iterations.

The dynamic-shape early-outs (identity when fewer than 3 keypoints,
correspondences or consistent pairs survive) are masked counts and a final
select, per pair.  Two extensions run after the method's fit when their
round counts (default 0) are set: `refit_rounds` of tight-sigma Gaussian
inlier reweighting with a Horn re-solve, and `trans_refine_rounds` of a
robust (Geman-McClure) mean of the translation votes pt - R ps under a
fixed R.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from relativepose_tpu_torch.core import horn
from relativepose_tpu_torch.match.keypoints import _take, topk_stable
from relativepose_tpu_torch.ops import kernels
from relativepose_tpu_torch.ops.kernels import (  # noqa: F401
    pair_weight_matrix_plain as pair_weight_matrix,
)

_EPS = 1e-12

FEAT_SCALING = 100.0
OBS_W = 1.2
SPECTRAL_OFFSET = 50.0
RES_SIGMA = 1.0


@dataclasses.dataclass(frozen=True)
class SolverStaticConfig:
    """Schedule constants; the same fields and defaults as the JAX package.

    `pallas_w_build` selects the pair-weight CUDA kernel (on by default, as
    the Pallas kernel is on the TPU); `use_pallas` selects the
    power-iteration CUDA kernel (off by default, as on the TPU).  On CPU
    tensors both wrappers run their plain versions.
    """

    top_k: int = 5
    num_reweighted: int = 5
    num_alter: int = 5
    power_iters: int = 30
    method: str = "irls+sm"   # 'horn87' | 'spectral' | 'irls' | 'irls+sm'
    use_pallas: bool = False
    refit_rounds: int = 0
    refit_sigma: float = 0.08
    trans_refine_rounds: int = 0
    trans_refine_sigma: float = 0.10
    pallas_w_build: bool = True


@dataclasses.dataclass
class SolverHyperParams:
    """Continuous hyper-parameters (the original rputil.py:11-22 values).

    Fields are Python floats (or 0-dim tensors); the kernel reads them as
    f32 scalars."""

    sigma_angle1: float = 0.523 / 2
    sigma_angle2: float = 0.523 / 2
    sigma_dist: float = 0.08 / 2
    sigma_feat: float = 0.01
    dist_thre: float = 0.08
    dist_sep_thre: float = 1.5 * 0.08
    angle_thre: float = 45.0 / 180.0 * 3.141592653589793
    mu: float = 0.3


# ---------------------------------------------------------------------------
# Stage 1: descriptor affinity + top-K correspondence candidates
# ---------------------------------------------------------------------------

def descriptor_affinity(feat_s, feat_t, w_s, w_t, valid_s, valid_t,
                        sigma_feat):
    """Row-normalized descriptor affinity wij [B, Ks, Kt].

    feat: [B, K, F] (already /100); w: [B, K] observation weights;
    valid: [B, K] bool.
    """
    d_ij = torch.sum((feat_s[:, :, None, :] - feat_t[:, None, :, :]) ** 2,
                     dim=-1)
    both_obs = (w_s[:, :, None] * w_t[:, None, :]) == 1.0
    sigma = torch.where(both_obs, sigma_feat / OBS_W, sigma_feat)
    wij = torch.exp(-d_ij / (2.0 * (sigma / 5.0) ** 2))
    wij = wij * valid_s[:, :, None] * valid_t[:, None, :]
    nm = torch.sqrt(torch.sum(wij * wij, dim=2, keepdim=True) + _EPS * _EPS)
    return wij / nm


def _gather_correspondences(wij, top_k):
    """Top-K targets per source -> (src_idx [C], tgt_idx [B, C], f [B, C])
    with C = Ks * top_k."""
    b, ks = wij.shape[:2]
    f_vals, tgt_idx = topk_stable(wij, top_k)
    src_idx = torch.arange(ks, device=wij.device).repeat_interleave(top_k)
    return src_idx, tgt_idx.reshape(b, -1), f_vals.reshape(b, -1)


# ---------------------------------------------------------------------------
# Stage 3: solvers in factorized per-correspondence form
# ---------------------------------------------------------------------------

def _power_iteration(matvec, v0, iters):
    """Dominant eigenvector of a nonneg symmetric operator, per pair."""
    v = v0
    for _ in range(iters):
        y = matvec(v)
        n = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True) + _EPS * _EPS)
        v = torch.where(n > 2.0 * _EPS, y / n, v)
    return v


def _spectral_eigvec(W, h, cfg):
    """Dominant eigenvector of A = W o (h (+) h): the CUDA kernel when
    cfg.use_pallas, else the batched matvec loop."""
    if cfg.use_pallas:
        return kernels.power_iteration(W, h, cfg.power_iters)

    def matvec(v):
        y = W @ torch.stack([v, h * v], dim=-1)
        return h * y[..., 0] + y[..., 1]

    return _power_iteration(matvec, torch.ones_like(h), cfg.power_iters)


def _rowsum_rank1(W, u):
    """Row sums of W o (u u^T): u * (W u).  W u is the first column of
    W @ [u, u]: torch's CPU matmul sums a single column in an order that
    depends on the batch, two columns in the same order for every batch,
    so a pair's result does not depend on the pairs beside it."""
    return u * (W @ torch.stack([u, u], dim=-1))[..., 0]


def _rotate(x, R):
    """x [B, N, 3] rotated by R [B, 3, 3]: x @ R^T."""
    return x @ R.transpose(-1, -2)


def _irls_rounds(ps, pt, ns, nt, rho, mu, num_rounds):
    """`num_rounds` of IRLS given per-correspondence row sums rho [B, C].

    Returns (R, t, mu_s, mu_t) of the LAST Horn solve."""
    b = ps.shape[0]
    f_pos = torch.ones_like(rho)
    f_nrm = torch.ones_like(rho)
    R = torch.eye(3, dtype=ps.dtype, device=ps.device).expand(b, 3, 3)
    t = ps.new_zeros((b, 3))
    mu_s = ps.new_zeros((b, 3))
    mu_t = ps.new_zeros((b, 3))
    for _ in range(num_rounds):
        w_pos = rho * f_pos
        w_nrm = rho * f_nrm
        mu_s = horn.weighted_centroid(ps, w_pos * mu)
        mu_t = horn.weighted_centroid(pt, w_pos * mu)
        ps_c = ps - mu_s[:, None]
        pt_c = pt - mu_t[:, None]
        all_s = torch.cat([ps_c, ns], dim=1)
        all_t = torch.cat([pt_c, nt], dim=1)
        all_w = torch.cat([w_pos * mu, w_nrm], dim=1)
        R = horn.horn87(all_s, all_t, all_w)
        t = mu_t - (R @ mu_s[..., None])[..., 0]
        r_pos = mu * torch.sum((_rotate(ps_c, R) - pt_c) ** 2, dim=-1)
        r_nrm = torch.sum((_rotate(ns, R) - nt) ** 2, dim=-1)
        f_pos = f_pos * RES_SIGMA**2 / (RES_SIGMA**2 + r_pos)
        f_nrm = f_nrm * RES_SIGMA**2 / (RES_SIGMA**2 + r_nrm)
    return R, t, mu_s, mu_t


def _residual_scores(ps, pt, ns, nt, R, mu_s, mu_t, mu):
    """h[c] = relu(offset - r[c]) with r the centred residual."""
    r = mu * torch.sum(
        (_rotate(ps - mu_s[:, None], R) - (pt - mu_t[:, None])) ** 2,
        dim=-1) + torch.sum((_rotate(ns, R) - nt) ** 2, dim=-1)
    return torch.clamp(SPECTRAL_OFFSET - r, min=0.0)


def fit_horn87(ps, pt, ns, nt, W, mu):
    """Single weighted Horn solve."""
    rho = torch.sum(W, dim=-1)
    return horn.fit_rigid(ps, pt, ns, nt, rho, rho, mu)


def fit_irls(ps, pt, ns, nt, W, mu, cfg: SolverStaticConfig):
    """IRLS."""
    rho = torch.sum(W, dim=-1)
    R, t, _, _ = _irls_rounds(ps, pt, ns, nt, rho, mu, cfg.num_reweighted)
    return R, t


def fit_spectral(ps, pt, ns, nt, W, mu, cfg: SolverStaticConfig):
    """Spectral matching alternation; u is the rank-1 pair-weight
    modulation (ones before the first spectral round)."""
    rho0 = torch.sum(W, dim=-1)
    R, t = horn.fit_rigid(ps, pt, ns, nt, rho0, rho0, mu)
    mu_s = horn.weighted_centroid(ps, rho0)
    mu_t = horn.weighted_centroid(pt, rho0)
    u = torch.ones_like(rho0)
    for _ in range(cfg.num_alter):
        h = _residual_scores(ps, pt, ns, nt, R, mu_s, mu_t, mu)
        u = _spectral_eigvec(W * u[:, :, None] * u[:, None, :], h, cfg)
        rho = _rowsum_rank1(W, u)
        mu_s = horn.weighted_centroid(ps, rho)
        mu_t = horn.weighted_centroid(pt, rho)
        ps_c = ps - mu_s[:, None]
        pt_c = pt - mu_t[:, None]
        all_s = torch.cat([ps_c, ns], dim=1)
        all_t = torch.cat([pt_c, nt], dim=1)
        all_w = torch.cat([rho * mu, rho], dim=1)
        R = horn.horn87(all_s, all_t, all_w)
        t = mu_t - (R @ mu_s[..., None])[..., 0]
    return R, t


def fit_irls_sm(ps, pt, ns, nt, W, mu, cfg: SolverStaticConfig):
    """IRLS + spectral matching, the default: IRLS rounds to initialize,
    then `num_alter` rounds of (residual scores -> spectral eigenvector of
    W o (h (+) h) -> IRLS seeded with the rank-1-modulated row sums)."""
    rho0 = torch.sum(W, dim=-1)
    R, t, mu_s, mu_t = _irls_rounds(ps, pt, ns, nt, rho0, mu,
                                    cfg.num_reweighted)
    for _ in range(cfg.num_alter):
        h = _residual_scores(ps, pt, ns, nt, R, mu_s, mu_t, mu)
        u = _spectral_eigvec(W, h, cfg)
        R, t, mu_s, mu_t = _irls_rounds(ps, pt, ns, nt, _rowsum_rank1(W, u),
                                        mu, cfg.num_reweighted)
    return R, t


def _refit(ps, pt, ns, nt, cw0, R, t, mu, cfg: SolverStaticConfig):
    """`refit_rounds` Gaussian-inlier Horn re-solves; a pair keeps its
    pose where a solve is not finite."""
    inv_2s2 = 1.0 / (2.0 * cfg.refit_sigma ** 2)
    for _ in range(cfg.refit_rounds):
        res2 = torch.sum((_rotate(ps, R) + t[:, None] - pt) ** 2, dim=-1)
        # the 1e-4 floor keeps the solve conditioned when nothing lands
        # within refit_sigma
        w_ref = cw0 * (torch.exp(-res2 * inv_2s2) + 1e-4)
        R2, t2 = horn.fit_rigid(ps, pt, ns, nt, w_ref, w_ref, mu)
        good = torch.isfinite(R2).flatten(1).all(-1) & \
            torch.isfinite(t2).all(-1)
        R = torch.where(good[:, None, None], R2, R)
        t = torch.where(good[:, None], t2, t)
    return R, t


def _trans_refine(ps, pt, cw0, R, t, cfg: SolverStaticConfig):
    """`trans_refine_rounds` Geman-McClure IRLS rounds on the votes
    pt - R ps, weights cw0 [B, C]; a pair keeps t where a round has no
    support or is not finite."""
    s2 = cfg.trans_refine_sigma ** 2
    votes = pt - _rotate(ps, R)
    for _ in range(cfg.trans_refine_rounds):
        r2 = torch.sum((votes - t[:, None]) ** 2, dim=-1)
        g = cw0 * (s2 / (s2 + r2))
        den = torch.sum(g, dim=-1)
        t2 = torch.sum(g[..., None] * votes, dim=1) / (den[:, None] + 1e-12)
        good = (den > 1e-8) & torch.isfinite(t2).all(-1)
        t = torch.where(good[:, None], t2, t)
    return t


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def estimate_relative_pose(data_s, data_t, hp: SolverHyperParams,
                           cfg: Optional[SolverStaticConfig] = None,
                           return_score: bool = False):
    """Relative poses of a batch of pairs of fixed-capacity keypoint sets.

    data_s/data_t: dicts with 'pc' [B, K, 3], 'normal' [B, K, 3], 'feat'
    [B, K, F] (unscaled), 'weight' [B, K] (1.0 observed / 0.99 not) and
    'valid' [B, K] bool.  Returns T [B, 4, 4] (identity on an early-out);
    with `return_score`, also the affinity-weighted inlier rate [B] of the
    candidate correspondences under T (0 on an early-out).
    """
    cfg = cfg or SolverStaticConfig()
    feat_s = data_s["feat"] / FEAT_SCALING
    feat_t = data_t["feat"] / FEAT_SCALING
    valid_s, valid_t = data_s["valid"], data_t["valid"]
    w_s, w_t = data_s["weight"], data_t["weight"]

    wij = descriptor_affinity(feat_s, feat_t, w_s, w_t, valid_s, valid_t,
                              hp.sigma_feat)
    src_idx, tgt_idx, f = _gather_correspondences(wij, cfg.top_k)

    ps = data_s["pc"][:, src_idx]
    pt = _take(data_t["pc"], tgt_idx)
    ns = data_s["normal"][:, src_idx]
    nt = _take(data_t["normal"], tgt_idx)
    obs_prod = w_s[:, src_idx] * _take(w_t, tgt_idx)
    cvalid = valid_s[:, src_idx] & _take(valid_t, tgt_idx) & (f > 0)

    build = (kernels.pair_weight_matrix if cfg.pallas_w_build
             else kernels.pair_weight_matrix_plain)
    W, counts = build(ps, pt, ns, nt, f, obs_prod, cvalid, hp)

    method = cfg.method
    if method == "horn87":
        R, t = fit_horn87(ps, pt, ns, nt, W, hp.mu)
    elif method == "irls":
        R, t = fit_irls(ps, pt, ns, nt, W, hp.mu, cfg)
    elif method == "spectral":
        R, t = fit_spectral(ps, pt, ns, nt, W, hp.mu, cfg)
    elif method == "irls+sm":
        R, t = fit_irls_sm(ps, pt, ns, nt, W, hp.mu, cfg)
    else:
        raise ValueError(f"unknown method {method!r}")

    if cfg.refit_rounds > 0:
        R, t = _refit(ps, pt, ns, nt, f * cvalid.to(f.dtype), R, t, hp.mu,
                      cfg)
    if cfg.trans_refine_rounds > 0:
        t = _trans_refine(ps, pt, torch.sum(W, dim=-1) * cvalid.to(f.dtype),
                          R, t, cfg)

    ok = (
        (valid_s.sum(-1) >= 3)
        & (valid_t.sum(-1) >= 3)
        & (cvalid.sum(-1) >= 3)
        & (counts["dist"] >= 3)
        & (counts["dist_angle"] >= 3)
        & (counts["nonzero_w"] >= 1)
        & torch.isfinite(R).flatten(1).all(-1)
        & torch.isfinite(t).all(-1)
    )
    b = ps.shape[0]
    eye = torch.eye(4, dtype=ps.dtype, device=ps.device)
    T = eye.repeat(b, 1, 1)
    T[:, :3, :3] = torch.where(ok[:, None, None], R, eye[:3, :3])
    T[:, :3, 3] = torch.where(ok[:, None], t, 0.0)
    if not return_score:
        return T
    res = torch.linalg.vector_norm(
        _rotate(ps, T[:, :3, :3]) + T[:, None, :3, 3] - pt, dim=-1)
    cw = f * cvalid.to(f.dtype)
    inlier = torch.sum(cw * (res < hp.dist_thre), dim=-1) / (
        torch.sum(cw, dim=-1) + 1e-12)
    return T, torch.where(ok, inlier, 0.0)
