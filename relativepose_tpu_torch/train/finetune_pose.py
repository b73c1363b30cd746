"""Pose-loss fine-tuning of SCNet through the recurrent pipeline.

Port of `relativepose_tpu/train/finetune_pose.py`.  The whole complete ->
match -> solve recurrence is differentiable in SCNet's outputs: keypoint
selection is discrete (top-k and argmax indices carry no gradient), but
every value the pose depends on (descriptors at the keypoints, 3-D lifts
from the completed depth, normals, solver weights, the Horn alignment) is
smooth in them.  So the final pose error is backpropagated into the
completion net.

Loss: rot_weight * ||R_hat - R_gt||_F^2 + trans_weight * ||t_hat - t_gt||^2
averaged over pairs, plus anchor_weight * the squared L2 distance of the
parameters from the starting ones.

The optimizer is the JAX package's `optax.chain(zero_nans(),
clip_by_global_norm(clip_norm), adam(learning_rate))`: NaN entries of the
gradients are zeroed, the gradients are scaled by clip_norm / global norm
(no epsilon) when that norm is not below clip_norm, and Adam
(`train.state.OptaxAdam`, b1 0.9, b2 0.999, eps 1e-8) steps on the
result.  The logged `grad_norm` is the global norm of the raw gradients.
Both CUDA kernels have no backward, so the pipeline configuration must
turn them off (`cli/finetune_pose.py` does, as the JAX driver does); a
kernel reached with inputs that require grad raises.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
from torch.profiler import record_function

from relativepose_tpu_torch.data import device_store as dstore
from relativepose_tpu_torch.pipeline.recurrent import (
    PipelineConfig,
    estimate_pose_via_completion,
    make_scnet_fn,
)
from relativepose_tpu_torch.train import state as tstate


@dataclasses.dataclass(frozen=True)
class PoseFinetuneConfig:
    learning_rate: float = 1e-5
    rot_weight: float = 1.0
    trans_weight: float = 0.25
    clip_norm: float = 1.0
    # L2 pull toward the starting parameters, so that the task loss
    # refines the completion prior instead of destroying it
    anchor_weight: float = 0.0
    ngf: int = 64
    dtype: Any = None    # SCNet's compute dtype (torch.bfloat16 on the card)


def gather_eval_pairs(arrays: dict, idx):
    """(data_s, data_t, T_gt) of the `idx` [B] pairs of a `DeviceStore`,
    decoded on the arrays' device as the pipeline consumes them (the raw
    views, no augmentation), with T_gt = pose_t @ inv(pose_s)."""
    rgb, norm, depth, _ = dstore.decode_batch(
        *(arrays[k][idx] for k in ("rgb", "norm", "depth", "segm")))
    pose = arrays["pose"][idx]
    data_s = {"rgb": rgb[:, 0], "norm": norm[:, 0], "depth": depth[:, 0]}
    data_t = {"rgb": rgb[:, 1], "norm": norm[:, 1], "depth": depth[:, 1]}
    if "rgb_full" in arrays:   # the ScanNet detection frames
        rgb_full = dstore.decode(arrays["rgb_full"][idx], "rgb")
        data_s["rgb_full"] = rgb_full[:, 0]
        data_t["rgb_full"] = rgb_full[:, 1]
    T_gt = pose[:, 1] @ torch.linalg.inv(pose[:, 0])
    return data_s, data_t, T_gt


def make_optimizer(params, cfg: PoseFinetuneConfig):
    """optax.adam(cfg.learning_rate); `train_step` gives every parameter
    a gradient (zeros where the loss did not reach it), zeroes NaNs and
    clips before it steps."""
    return tstate.OptaxAdam(params, lr=cfg.learning_rate)


def init_state(net, cfg: PoseFinetuneConfig) -> tstate.TrainState:
    """A `TrainState` around the SCNet `net` (its npz checkpoints hold
    SCNet's keys at the root, as the completion trainer's do); with an
    anchor, a frozen copy of the starting parameters."""
    frozen = {}
    if cfg.anchor_weight > 0.0:
        frozen["anchor"] = copy.deepcopy(net).requires_grad_(False)
    return tstate.TrainState({"scnet": net},
                             make_optimizer(net.parameters(), cfg),
                             root="scnet", frozen=frozen)


def global_norm(tensors):
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def zero_nans_and_clip(grads, max_norm: float):
    """optax's zero_nans() then clip_by_global_norm(max_norm)."""
    grads = [torch.where(torch.isnan(g), 0.0, g) for g in grads]
    g_norm = global_norm(grads)
    keep = g_norm < max_norm
    return [torch.where(keep, g, g / g_norm * max_norm) for g in grads]


def loss_fn(net, anchor, data_s, data_t, T_gt, pipe_cfg: PipelineConfig, hp,
            cfg: PoseFinetuneConfig, draws=None, generator=None):
    """(loss, metrics) of one batch of pairs."""
    T = estimate_pose_via_completion(
        make_scnet_fn(net), data_s, data_t, hp, pipe_cfg, draws=draws,
        generator=generator, device=T_gt.device)
    rot = torch.sum((T[:, :3, :3] - T_gt[:, :3, :3]) ** 2, dim=(-2, -1))
    tr = torch.sum((T[:, :3, 3] - T_gt[:, :3, 3]) ** 2, dim=-1)
    loss = torch.mean(cfg.rot_weight * rot + cfg.trans_weight * tr)
    metrics = {"rot_frob2": torch.mean(rot), "trans_se": torch.mean(tr)}
    if cfg.anchor_weight > 0.0:
        l_anchor = sum(torch.sum((p - a) ** 2) for p, a in
                       zip(net.parameters(), anchor.parameters()))
        metrics["anchor_l2"] = l_anchor
        loss = loss + cfg.anchor_weight * l_anchor
    metrics["loss"] = loss
    return loss, metrics


def make_finetune_step(pipe_cfg: PipelineConfig, hp,
                       cfg: PoseFinetuneConfig):
    """train_step(state, data_s, data_t, T_gt, draws=None, generator=None)
    -> detached metrics; one step in place on `state` (`init_state`).
    draws: per recurrence step `KeypointDraws`, else drawn from
    `generator`."""

    def train_step(state, data_s, data_t, T_gt, draws=None, generator=None):
        net = state.models["scnet"]
        params = state.parameters()
        with record_function("rp.forward"):
            loss, metrics = loss_fn(net, state.frozen.get("anchor"), data_s,
                                    data_t, T_gt, pipe_cfg, hp, cfg, draws,
                                    generator)
        with record_function("rp.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        with record_function("rp.adam"):
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            metrics["grad_norm"] = global_norm(grads)
            for p, g in zip(params, zero_nans_and_clip(grads,
                                                       cfg.clip_norm)):
                p.grad = g
            state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step
