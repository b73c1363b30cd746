"""Feature-learning training step.

Port of `relativepose_tpu/train/feature.py`: Resnet18_8s (and a
segmentation head) trained with the contrastive correspondence loss on
complete panoramas; both views go in unmasked, and features are pulled
together at the ground-truth correspondences and pushed apart from
negatives; an optional segmentation cross-entropy x0.1.

Adam(2e-4, betas=(0.5, 0.999)).  A batch with no valid correspondence set
multiplies the gradients by 0 and still steps Adam, as the JAX step does:
the moments decay and the step count advances.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.profiler import record_function

from relativepose_tpu_torch.models.resnet import Resnet18_8s, SegmentationHead
from relativepose_tpu_torch.train import losses
from relativepose_tpu_torch.train.state import (
    TrainState,
    grad_norm,
    init_models,
    make_optimizer,
)


@dataclasses.dataclass(frozen=True)
class FeatureTrainConfig:
    snumclass: int = 15
    feature_dim: int = 32
    use_tanh: bool = True
    margin: float = 0.5
    # the hardest of a candidate pool instead of uniform negatives
    # (losses.contrastive_loss; False = the original uniform loss)
    hard_negatives: bool = True
    featlearn_segm: bool = False
    learning_rate: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    base_width: int = 64
    dtype: Any = None    # compute dtype (torch.bfloat16 on the card)


def build_models(cfg: FeatureTrainConfig):
    net_f = Resnet18_8s(num_input=7, feature_dim=cfg.feature_dim,
                        use_tanh=cfg.use_tanh, base_width=cfg.base_width,
                        dtype=cfg.dtype)
    seg = SegmentationHead(cfg.feature_dim, cfg.snumclass, dtype=cfg.dtype)
    return net_f, seg


def init_state(cfg: FeatureTrainConfig, device="cuda",
               seed: int = 0) -> TrainState:
    net_f, seg = init_models(lambda: build_models(cfg), seed)
    models = {"net_f": net_f.to(device), "seg": seg.to(device)}
    opt = make_optimizer((p for m in models.values() for p in m.parameters()),
                         cfg.learning_rate, cfg.b1, cfg.b2)
    return TrainState(models, opt)


def pack(batch, v):
    """[n, 2, ...] -> [2n, ...], all first views then all second views."""
    return torch.cat([batch[v][:, 0], batch[v][:, 1]], dim=0)


def complete_views(batch):
    """The unmasked [2n, H, W, 7] rgb + normal + depth stack."""
    return torch.cat([pack(batch, "rgb"), pack(batch, "norm"),
                      pack(batch, "depth")[..., None]], dim=-1)


def draw_negatives(cfg, batch, generator=None):
    """The contrastive loss's negatives for `batch` from `generator`."""
    n, k = batch["denseCorres"]["idx_src"].shape[:2]
    h, w = batch["rgb"].shape[2:4]
    return losses.draw_negatives(n, k, h, w, cfg.hard_negatives,
                                 generator=generator,
                                 device=batch["rgb"].device)


def loss_fn(models, batch, negatives, cfg: FeatureTrainConfig):
    """batch: rgb [n, 2, H, W, 3], norm [n, 2, H, W, 3], depth [n, 2, H, W],
    dataMask [n, 2, H, W, 1], segm [n, 2, H, W], denseCorres with a
    leading [n].  Returns (total, metrics of 0-d tensors)."""
    n = batch["rgb"].shape[0]
    feat = models["net_f"](complete_views(batch))
    loss_fl, loss_pos, loss_neg = losses.contrastive_loss(
        feat[:n], feat[n:], batch["denseCorres"], negatives, cfg.margin,
        hard_negatives=cfg.hard_negatives)
    metrics = {"loss_fl": loss_fl, "loss_fl_pos": loss_pos,
               "loss_fl_neg": loss_neg}
    total = loss_fl
    if cfg.featlearn_segm:
        seg_pred = models["seg"](feat)
        loss_s = losses.weighted_ce(seg_pred, pack(batch, "segm"),
                                    pack(batch, "dataMask"))
        metrics["loss_s"] = loss_s
        total = total + loss_s
    metrics["loss"] = total
    return total, metrics


def train_step(state: TrainState, batch, negatives,
               cfg: FeatureTrainConfig) -> dict:
    """One Adam step in place; returns the detached metrics and the
    gradient norm (before the validity scaling)."""
    params = state.parameters()
    state.optimizer.zero_grad(set_to_none=False)
    with record_function("rp.forward"):
        total, metrics = loss_fn(state.models, batch, negatives, cfg)
    with record_function("rp.backward"):
        total.backward()
    with record_function("rp.adam"):
        metrics["grad_norm"] = grad_norm(params)
        any_valid = (torch.sum(batch["denseCorres"]["valid"]) > 0).to(
            torch.float32)
        for p in params:
            p.grad.mul_(any_valid)
        state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def eval_metrics(state: TrainState, batch, negatives,
                 cfg: FeatureTrainConfig) -> dict:
    with torch.no_grad():
        return loss_fn(state.models, batch, negatives, cfg)[1]
