"""The recurrent complete <-> match <-> solve loop, batched over pano pairs.

Port of `relativepose_tpu/pipeline/recurrent.py`.  Per recurrence step:
  1. warp each view's observed region through the current pose into the
     other view's frame;
  2. complete both [view ; warped counterpart] stacks with the completion
     net (BatchNorm statistics per pair, over its 2 views);
  3. composite: observed regions keep their normal/depth, completed regions
     take the network output; renormalize normals;
  4. extract keypoints, descriptors and 3D lifts;
  5. solve for the next pose with this step's sigma values, and with
     `icp_iters` > 0 polish it by dense ICP (`ops/icp.py`).

A Python loop over `alter_steps` takes the place of `lax.scan`; every
tensor carries a leading pair dimension and no loop runs over pairs.  DoG
detection runs once per view; for ScanNet on the 480x640 'rgb_full'
frames.  Every step's keypoint draws are made once, before the loop.

With `remat`, each step runs under `torch.utils.checkpoint` (the
counterpart of `jax.checkpoint`): its activations are dropped after the
forward and recomputed in the backward, so training through the pipeline
holds one step's activations at a time.  The recompute must see the same
keypoints: `torch.utils.checkpoint` replays the default generators only,
never an explicit `torch.Generator`, which is why the draws are made
before the loop and handed to the steps as tensors; and cuDNN runs such a
step with deterministic algorithms only, so that the recompute repeats
the forward bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.utils.checkpoint
from torch.profiler import record_function

from relativepose_tpu_torch import config
from relativepose_tpu_torch.config import ChannelLayout
from relativepose_tpu_torch.core import masking, rotation, warp
from relativepose_tpu_torch.match import primitives
from relativepose_tpu_torch.match.keypoints import (
    KeypointConfig,
    KeypointDraws,
    detect_observed,
    draw_keypoints,
    draw_keypoints_per_pair,
    rgb_to_gray,
)
from relativepose_tpu_torch.match.solver import (
    SolverHyperParams,
    SolverStaticConfig,
    estimate_relative_pose,
)
from relativepose_tpu_torch.ops import icp

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The same fields as the JAX package's PipelineConfig.  `unroll` has
    no effect here: the recurrence is always a Python loop.  With
    `icp_iters` > 0 each step's pose is ICP-polished (`icp_dof` 6 or 3)
    unless it is exactly the identity (the solver's early-out); the step's
    score stays the solver's score of the pose before the polish, as in
    the JAX package."""

    dataset: str = "suncg"
    mask_method: str = "second"
    alter_steps: int = 3
    completion: bool = True
    unroll: bool = False
    remat: bool = False
    output_type: str = "rgbdnsf"
    snumclass: int = 15
    feature_dim: int = 32
    keypoints: KeypointConfig = KeypointConfig()
    solver: SolverStaticConfig = SolverStaticConfig()
    step_select: str = "last"
    min_score: float = 0.0
    icp_iters: int = 0
    icp_dof: int = 6

    @property
    def layout(self) -> ChannelLayout:
        return ChannelLayout(self.output_type, self.snumclass,
                             self.feature_dim)


def set_numerics():
    """Geometry and the solver run in full f32: TF32 off for matmuls and
    cuDNN convolutions (the JAX package pins Precision.HIGHEST)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def as_pair_batch(data: dict, device) -> dict:
    """Dict of [B, ...] arrays or tensors -> tensors on `device` (floats as
    f32); the 'pose' entry is dropped."""
    out = {}
    for k, v in data.items():
        if k == "pose":
            continue
        t = torch.as_tensor(v, device=device)
        out[k] = t.float() if t.is_floating_point() else t
    return out


def make_view(rgb, norm, depth, mask_method: str):
    """Complete panos -> masked 8-channel views + observation masks.

    rgb: [B, H, W, 3] in [0, 1]; norm: [B, H, W, 3]; depth: [B, H, W].
    Returns (view [B, H, W, 8], mask [B, H, W, 1])."""
    complete = torch.cat([rgb, norm, depth[..., None]], dim=-1)
    view, mask, _ = masking.apply_mask(complete, mask_method)
    tpmask = (view[..., 6:7] != 0).to(view.dtype)
    return torch.cat([view, tpmask], dim=-1), mask


def make_scnet_fn(net):
    """Completion function of an `SCNet` for the pipeline:
    [B, 2, H, W, 16] -> [B, 2, H, W, out] f32, BatchNorm per pair."""

    def scnet_fn(x):
        y = net(x.flatten(0, 1), group=2)
        return y.float().unflatten(0, x.shape[:2])

    return scnet_fn


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to deterministic algorithms.  A rematerialised
    step must repeat its forward bit for bit in the backward (the same
    heatmap picks): on the card, f32 convolutions otherwise differ from
    one call to the next, enough to move a keypoint."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _sigma_at(val, i):
    if isinstance(val, (int, float)):
        return float(val)
    arr = torch.as_tensor(val).reshape(-1)
    return float(arr[i]) if arr.numel() > 1 else float(arr[0])


def estimate_pose_via_completion(
    scnet_fn: Callable,
    data_s: dict,
    data_t: dict,
    hp_table: SolverHyperParams,
    cfg: PipelineConfig,
    T_init: Optional[torch.Tensor] = None,
    draws: Optional[Sequence[Optional[KeypointDraws]]] = None,
    generator: Optional[torch.Generator] = None,
    return_step_poses: bool = False,
    return_primitives: bool = False,
    device="cuda",
):
    """Run the full recurrent algorithm for a batch of pano pairs.

    scnet_fn: [B, 2, H, W, 16] -> [B, 2, H, W, num_output] (`make_scnet_fn`
    or the oracle).  data_s/data_t: dicts of [B, ...] 'rgb' (BGR in
    [0, 1]), 'norm', 'depth', and for ScanNet 'rgb_full' [B, 480, 640,
    3].  hp_table: SolverHyperParams whose sigma fields are floats or
    per-step sequences.  draws: per step, the
    keypoint draws (`KeypointDraws`) or None to draw them from
    `generator` before the first step.  Returns T [B, 4, 4]; with
    `return_step_poses` also the step poses [B, steps, 4, 4], and with
    `return_primitives` also, per step, the solver-ready (prim_s, prim_t)
    dicts of [B, ...] tensors (`match.primitives.extract_primitives`), in
    that order.
    """
    set_numerics()
    data_s = as_pair_batch(data_s, device)
    data_t = as_pair_batch(data_t, device)
    lay = cfg.layout
    f_lo, f_hi = lay.spans["f"]
    b = data_s["rgb"].shape[0]

    view_s, mask_s = make_view(data_s["rgb"], data_s["norm"],
                               data_s["depth"], cfg.mask_method)
    view_t, mask_t = make_view(data_t["rgb"], data_t["norm"],
                               data_t["depth"], cfg.mask_method)
    eye = torch.eye(4, device=view_s.device)
    T = eye.repeat(b, 1, 1) if T_init is None else torch.as_tensor(
        T_init, dtype=torch.float32, device=view_s.device)

    gray_full_s = gray_full_t = None
    if config.canonical_dataset(cfg.dataset) == "scannet":
        gray_full_s = rgb_to_gray(data_s["rgb_full"] * 255.0)
        gray_full_t = rgb_to_gray(data_t["rgb_full"] * 255.0)

    # DoG detection sees only the masked observed rgb (or the ScanNet full
    # frame), which the recurrence never changes: detect once, reuse in
    # every step
    with record_function("rp.detect"):
        det_s = detect_observed(mask_s * data_s["rgb"] * 255.0,
                                cfg.keypoints, gray_full_s)
        det_t = detect_observed(mask_t * data_t["rgb"] * 255.0,
                                cfg.keypoints, gray_full_t)
    # every step's draws before the first step, in the order the steps
    # would make them: a rematerialised step must not draw again
    draw = draw_keypoints_per_pair if isinstance(generator, (list, tuple)) \
        else draw_keypoints
    draws = [d if d is not None else draw(
        det_s[1], det_t[1], cfg.keypoints, cfg.mask_method, generator)
        for d in (draws or [None] * cfg.alter_steps)]

    def composite(fv, mask, data):
        nrm = (1.0 - mask) * fv[..., 3:6] + mask * data["norm"]
        nrm = nrm / torch.sqrt(torch.sum(nrm * nrm, -1, keepdim=True) + _EPS)
        depth = (1.0 - mask[..., 0]) * fv[..., 6] \
            + mask[..., 0] * data["depth"]
        rgb = mask * data["rgb"] * 255.0
        return rgb, nrm, depth

    def step_body(T, step):
        """One recurrence step: (T, step) -> (next T, score, (prim_s,
        prim_t)).  The record_function ranges name the stages in a
        profiler trace."""
        with record_function("rp.warp"):
            view_t2s = warp.warp_view(view_t, rotation.inverse_se3(T),
                                      cfg.dataset)
            view_s2t = warp.warp_view(view_s, T, cfg.dataset)
            inp = torch.stack([torch.cat([view_s, view_t2s], -1),
                               torch.cat([view_t, view_s2t], -1)], dim=1)
        with record_function("rp.scnet"):
            f = scnet_fn(inp)
        f0, f1 = f[:, 0], f[:, 1]
        with record_function("rp.keypoints"):
            rgb_sc, nrm_sc, dep_sc = composite(f0, mask_s, data_s)
            rgb_tc, nrm_tc, dep_tc = composite(f1, mask_t, data_t)
            prim_s, prim_t = primitives.extract_primitives(
                rgb_sc, rgb_tc, dep_sc, dep_tc, nrm_sc, nrm_tc,
                f0[..., f_lo:f_hi], f1[..., f_lo:f_hi], cfg.keypoints,
                cfg.dataset, cfg.mask_method, do_completion=cfg.completion,
                det_s=det_s, det_t=det_t, draws=draws[step])

        hp_step = SolverHyperParams(
            sigma_angle1=_sigma_at(hp_table.sigma_angle1, step),
            sigma_angle2=_sigma_at(hp_table.sigma_angle2, step),
            sigma_dist=_sigma_at(hp_table.sigma_dist, step),
            sigma_feat=_sigma_at(hp_table.sigma_feat, step),
            dist_thre=hp_table.dist_thre,
            dist_sep_thre=hp_table.dist_sep_thre,
            angle_thre=hp_table.angle_thre,
            mu=hp_table.mu,
        )
        with record_function("rp.solver"):
            T, score = estimate_relative_pose(prim_s, prim_t, hp_step,
                                              cfg.solver, return_score=True)
        if cfg.icp_iters > 0:
            with record_function("rp.icp"):
                # the identity is the solver's "no usable
                # correspondences": it is not polished
                is_id = torch.all((T - eye).abs().flatten(1) == 0, dim=-1)
                T_p = icp.icp_polish(
                    T, dep_sc, nrm_sc, dep_tc, nrm_tc, cfg.dataset,
                    iters=cfg.icp_iters, dof=cfg.icp_dof,
                    obs_s=mask_s[..., 0], obs_t=mask_t[..., 0])
                T = torch.where(is_id[:, None, None], T, T_p)
        return T, score, (prim_s, prim_t)

    step_fn = step_body
    if cfg.remat and torch.is_grad_enabled():
        def remat_body(T, step):
            with cudnn_deterministic():
                return step_body(T, step)

        def step_fn(T, step):
            return torch.utils.checkpoint.checkpoint(
                remat_body, T, step, use_reentrant=False)

    step_ts, scores, prims = [], [], []
    for step in range(cfg.alter_steps):
        T, score, prim = step_fn(T, step)
        step_ts.append(T)
        scores.append(score)
        prims.append(prim)

    step_ts = torch.stack(step_ts, dim=1)
    if cfg.step_select == "best_score":
        scores = torch.stack(scores, dim=1)
        best = torch.argmax(scores, dim=1)
        T = step_ts[torch.arange(b, device=best.device), best]
        if cfg.min_score > 0.0:
            low = torch.amax(scores, dim=1) < cfg.min_score
            T = torch.where(low[:, None, None], eye, T)
    elif cfg.step_select != "last":
        raise ValueError(f"unknown step_select {cfg.step_select!r}")

    out = (T,)
    if return_step_poses:
        out += (step_ts,)
    if return_primitives:
        out += (prims,)
    return out if len(out) > 1 else T


def batched_pose_estimator(scnet_fn, cfg: PipelineConfig, device="cuda"):
    """fn(data_s, data_t, hp_table, generator=None, draws=None) ->
    [B, 4, 4], the counterpart of the JAX package's vmapped estimator."""

    def fn(data_s, data_t, hp_table, generator=None, draws=None):
        return estimate_pose_via_completion(
            scnet_fn, data_s, data_t, hp_table, cfg, draws=draws,
            generator=generator, device=device)

    return fn
