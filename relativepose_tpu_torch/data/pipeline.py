"""Device-side training data: dense correspondences and reprojection.

Port of `relativepose_tpu/data/pipeline.py`, batched over pano pairs
(the JAX package maps `assemble_pair_batch` over pairs with `vmap`).  The
random draws are tensors in `PairDraws`; `draw_pair_batch` makes them
from a torch generator, and a test can hand the JAX package's draws in.

Numerics that decide integer outputs follow the JAX package on the CPU
bit for bit, on every device: the nearest-neighbour distances are the same
expansion |q|^2 - 2 q.r + |r|^2, each a fused multiply-add chain over the
3 coordinates as in XLA's CPU program (`rotation.fma_dot`; the dot as a
matmul, which rounds that way), the small pose products likewise
(`rotation.small_matmul`), and the
weighted choice among matches is `jax.random.choice`'s inverse CDF over
XLA's CPU cumulative sum (`_xla_cumsum`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from relativepose_tpu_torch import config
from relativepose_tpu_torch.core import rotation, skybox, warp
from relativepose_tpu_torch.core.rotation import (
    fma_dot,
    inverse_se3,
    small_matmul,
)

H, W = config.PANO_HEIGHT, config.PANO_WIDTH
N_QUERY = 5000
N_CORRES = 2000
MIN_CORRES = 500
CORR_THRESH = 0.08
_BIG = 1e30
_MAX_ELEMS = 1 << 27   # largest [B, chunk, M] distance block (512 MB f32)

# Per-dataset protocol: suncg queries uniformly over the full pano grid;
# matterport and scannet query valid (nonzero-depth) points only; scannet
# keeps 500 correspondences and needs >= 200 matches, the others keep
# 2000 and need >= 500.
CORRES_PARAMS = {
    "suncg": dict(n_query=N_QUERY, n_corres=N_CORRES,
                  min_corres=MIN_CORRES, masked_queries=False),
    "matterport": dict(n_query=N_QUERY, n_corres=N_CORRES,
                       min_corres=MIN_CORRES, masked_queries=True),
    "scannet": dict(n_query=N_QUERY, n_corres=500, min_corres=200,
                    masked_queries=True),
}


class PairDraws(NamedTuple):
    """The random draws of one batch of pairs.

    q_idx [B, n_query]: query point indices into the source pano's point
    cloud; pick_u [B, n_corres]: uniforms in [0, 1) for the choice among
    matches; axis_u [B, 2, 3], angle_n [B, 2], trans_n [B, 2, 3]: the
    rotation-axis uniforms, angle normals and translation normals of the
    two perturbed warps (index 0 warps view 1 into view 0's frame, index 1
    view 0 into view 1's)."""
    q_idx: torch.Tensor
    pick_u: torch.Tensor
    axis_u: torch.Tensor
    angle_n: torch.Tensor
    trans_n: torch.Tensor


def draw_pair_batch(depth, dataset: str, generator=None) -> PairDraws:
    """Draws for `assemble_pair_batch` from a torch generator.

    depth: [B, 2, H, W] (view 0's valid points weight masked queries)."""
    prm = CORRES_PARAMS[config.canonical_dataset(dataset)]
    b, dev = depth.shape[0], depth.device
    n_pts = depth.shape[-2] * depth.shape[-1]

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    if prm["masked_queries"]:
        _, val_s = skybox.pano_to_pointcloud(depth[:, 0], dataset)
        q_idx = torch.multinomial(val_s.float() + 1e-9, prm["n_query"],
                                  replacement=True, generator=generator)
    else:
        q_idx = torch.randint(0, n_pts, (b, prm["n_query"]),
                              generator=generator, device=dev)
    return PairDraws(q_idx, rand(b, prm["n_corres"]), rand(b, 2, 3),
                     randn(b, 2), randn(b, 2, 3))


def _xla_cumsum(x):
    """Cumulative sum over the last axis in the order XLA's CPU backend
    uses for `jnp.cumsum`: sequential sums within blocks of 16, the block
    totals scanned the same way and added to the later blocks.  Only
    elementwise adds, so every device rounds alike."""
    n = x.shape[-1]
    if n <= 16:
        return torch.stack(list(_seq_sums(x.unbind(-1))), dim=-1)
    m = -(-n // 16)
    xp = torch.nn.functional.pad(x, (0, m * 16 - n))
    blocks = xp.reshape(x.shape[:-1] + (m, 16))
    within = torch.stack(list(_seq_sums(blocks.unbind(-1))), dim=-1)
    pref = _xla_cumsum(within[..., -1])
    within = torch.cat([within[..., :1, :],
                        within[..., 1:, :] + pref[..., :-1, None]], dim=-2)
    return within.reshape(xp.shape)[..., :n]


def _seq_sums(cols):
    acc = None
    for c in cols:
        acc = c if acc is None else acc + c
        yield acc


def _choice(u, weights):
    """`jax.random.choice(p=weights / sum)` with replacement, given its
    uniforms u [B, n]: the first index whose cumulative weight reaches
    total * (1 - u)."""
    p = weights / torch.sum(weights, dim=-1, keepdim=True)
    cum = _xla_cumsum(p)
    r = cum[..., -1:] * (1.0 - u)
    return torch.searchsorted(cum.contiguous(), r)


def _nn_with_idx(query, ref, rvalid):
    """Least squared distance and first index of the nearest valid ref
    point for each query.  query [B, N, 3]; ref [B, M, 3]."""
    b, m = ref.shape[:2]
    chunk = max(1, min(query.shape[1], _MAX_ELEMS // max(1, b * m)))
    ref_t = ref.transpose(1, 2)
    # ((a - 2 dot) + |r|^2) + pen equals (a - 2 dot) + (|r|^2 + pen): pen is
    # 0 or so large that the sum rounds to it either way
    ref_pen = fma_dot(ref, ref) + torch.where(rvalid, 0.0, _BIG)
    dists, idxs = [], []
    for lo in range(0, query.shape[1], chunk):
        qc = query[:, lo: lo + chunk]
        # (-2q) . r is -2 (q . r) exactly: scaling by 2 commutes with
        # rounding
        d2 = torch.bmm(-2.0 * qc, ref_t)
        d2 += fma_dot(qc, qc)[..., None]
        d2 += ref_pen[:, None, :]
        d, i = torch.min(d2, dim=-1)
        dists.append(d)
        idxs.append(i)
    return torch.cat(dists, dim=1), torch.cat(idxs, dim=1)


def _to_world(pc, pose):
    inv = inverse_se3(pose)
    return pc @ inv[:, :3, :3].transpose(-1, -2) + inv[:, None, :3, 3]


def dense_correspondences(depth_s, depth_t, pose_s, pose_t, q_idx, pick_u,
                          dataset: str, min_corres: int | None = None):
    """Ground-truth dense correspondences between the two panos of each
    pair.

    depth_*: [B, H, W]; pose_*: [B, 4, 4] world->camera; q_idx
    [B, n_query] and pick_u [B, n_corres] from `PairDraws`.  Lifts both
    panos to the world frame, finds each query's nearest target point
    within 0.08 m and picks n_corres of the matched queries.  Returns
    dict(idx_src [B, n_corres, 2], idx_tgt [B, n_corres, 2] int64 pano
    (x, y), valid [B] int32): valid is 0 when fewer than `min_corres`
    queries matched (the dataset's row of `CORRES_PARAMS` by default)."""
    if min_corres is None:
        min_corres = CORRES_PARAMS[config.canonical_dataset(dataset)][
            "min_corres"]
    pc_s, val_s = skybox.pano_to_pointcloud(depth_s, dataset)
    pc_t, val_t = skybox.pano_to_pointcloud(depth_t, dataset)
    pc_s = _to_world(pc_s, pose_s)
    pc_t = _to_world(pc_t, pose_t)
    q = torch.gather(pc_s, 1, q_idx[..., None].expand(-1, -1, 3))
    q_valid = torch.gather(val_s, 1, q_idx)
    d2, nn_idx = _nn_with_idx(q, pc_t, val_t)
    has_corres = (d2 < CORR_THRESH ** 2) & q_valid
    n_match = torch.sum(has_corres, dim=-1)
    sel = _choice(pick_u, has_corres.to(torch.float32) + 1e-9)
    return {
        "idx_src": skybox.pano_idx(torch.gather(q_idx, 1, sel)),
        "idx_tgt": skybox.pano_idx(torch.gather(nn_idx, 1, sel)),
        "valid": (n_match >= min_corres).to(torch.int32),
    }


def _first_last(flags, n):
    """First and last True index of flags [B, n] (n and -1 when none)."""
    i = torch.arange(n, device=flags.device)
    first = torch.amin(torch.where(flags, i, n), dim=-1)
    last = torch.amax(torch.where(flags, i, -1), dim=-1)
    return first, last


def reproj_augment(view8_src, pose_src, pose_tgt, axis_u, angle_n, trans_n,
                   dataset: str, epsilon: float = 0.1, t_sigma: float = 0.1):
    """Pose-perturbed cross-view reprojection, batched.

    Warps each view8_src [B, H, W, 8]'s observed region into the target
    frame under the ground-truth relative pose perturbed by a random
    rotation (`rotation.random_rotation(axis_u, angle_n, epsilon)`) and
    trans_n * t_sigma of translation.  Returns dict(view8 [B, H, W, 8],
    box [B, H, W] the half-open envelope of the splat, dr [B, 4, 4] =
    T_true @ inv(T_perturbed))."""
    T_true = small_matmul(pose_tgt, inverse_se3(pose_src))
    dR = rotation.random_rotation(axis_u, angle_n, epsilon)
    T_pert = T_true.clone()
    T_pert[:, :3, :3] = small_matmul(dR, T_true[:, :3, :3])
    T_pert[:, :3, 3] = T_true[:, :3, 3] + trans_n * t_sigma
    warped = warp.warp_view(view8_src, T_pert, dataset)
    dr = small_matmul(T_true, inverse_se3(T_pert))

    hit = warped[..., 6] != 0
    cols, rows = torch.any(hit, dim=-2), torch.any(hit, dim=-1)
    any_pix = torch.any(cols, dim=-1)
    c0, c1 = _first_last(cols, W)
    r0, r1 = _first_last(rows, H)
    c0 = torch.where(any_pix, c0, 0)[:, None, None]
    r0 = torch.where(any_pix, r0, 0)[:, None, None]
    c1 = torch.where(any_pix, c1, W - 1)[:, None, None]
    r1 = torch.where(any_pix, r1, H - 1)[:, None, None]
    ri = torch.arange(H, device=hit.device)[None, :, None]
    ci = torch.arange(W, device=hit.device)[None, None, :]
    box = ((ri >= r0) & (ri < r1) & (ci >= c0) & (ci < c1)).to(
        warped.dtype)
    return {"view8": warped, "box": box, "dr": dr}


def assemble_pair_batch(rgb, norm, depth, poses, segm, draws: PairDraws,
                        dataset: str, feature_learning: bool = True):
    """Training tensors of a batch of pano pairs, on their device.

    rgb: [B, 2, H, W, 3] in [0, 1]; norm: [B, 2, H, W, 3]; depth:
    [B, 2, H, W]; poses: [B, 2, 4, 4]; segm: [B, 2, H, W] int.  Returns
    the dict the completion and feature steps consume: the inputs,
    dataMask, proj_view8 / proj_box / proj_dr [B, 2, ...] (index 0 the
    t->s warp into view 0's frame, 1 the s->t warp) and, with
    feature_learning, denseCorres."""
    b = rgb.shape[0]
    data_mask = (depth != 0).to(rgb.dtype)[..., None]
    out = {"rgb": rgb, "norm": norm, "depth": depth, "segm": segm,
           "dataMask": data_mask, "pose": poses}
    view8 = torch.cat([rgb, norm, depth[..., None], data_mask], dim=-1)
    # both warps of every pair in one batch of 2B: (t->s, s->t) per pair
    src = view8.flip(1).reshape((2 * b,) + view8.shape[2:])
    pose_src = poses.flip(1).reshape(2 * b, 4, 4)
    pose_tgt = poses.reshape(2 * b, 4, 4)
    r = reproj_augment(src, pose_src, pose_tgt,
                       draws.axis_u.reshape(2 * b, 3),
                       draws.angle_n.reshape(2 * b),
                       draws.trans_n.reshape(2 * b, 3), dataset)
    out["proj_view8"] = r["view8"].reshape(view8.shape)
    out["proj_box"] = r["box"].reshape(depth.shape)
    out["proj_dr"] = r["dr"].reshape(b, 2, 4, 4)
    if feature_learning:
        out["denseCorres"] = dense_correspondences(
            depth[:, 0], depth[:, 1], poses[:, 0], poses[:, 1], draws.q_idx,
            draws.pick_u, dataset)
    return out
