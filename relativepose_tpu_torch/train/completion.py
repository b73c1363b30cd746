"""Pano-completion training step.

Port of `relativepose_tpu/train/completion.py`: SCNet (netG) trained
against a frozen feature net (netF).
  * Inputs: each view masked ('second' / 'kinect', the training variant
    of the weights) and paired with either a blank counterpart (type 0)
    or the pose-perturbed warped counterpart (type 1): the batch is
    [s_type0; t_type0; s_type1; t_type1], 4n rows.  SCNet's BatchNorm
    statistics are taken over all 4n rows (`group=None`), as the JAX
    training step does; the pose pipeline instead takes them per pair.
  * Losses: masked L1 per modality against the complete views, CE x0.1
    for semantics, the feature consistency with netF (or the procedural
    photometric descriptors) on the complete views, the contrastive loss
    on the completed features of a randomly drawn input type, and the
    optional plane-normal loss.

The draws (input type and negatives) are tensors in `CompletionDraws`.
Adam(2e-4, betas=(0.5, 0.999)) on SCNet's parameters only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.profiler import record_function

from relativepose_tpu_torch.config import ChannelLayout
from relativepose_tpu_torch.core import masking
from relativepose_tpu_torch.models.resnet import Resnet18_8s
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.pipeline.oracle import procedural_descriptors
from relativepose_tpu_torch.train import losses
from relativepose_tpu_torch.train.feature import complete_views, pack
from relativepose_tpu_torch.train.state import (
    TrainState,
    grad_norm,
    init_models,
    make_optimizer,
)


@dataclasses.dataclass(frozen=True)
class CompletionTrainConfig:
    dataset: str = "suncg"
    mask_method: str = "second"
    output_type: str = "rgbdnsf"
    snumclass: int = 15
    feature_dim: int = 32
    use_tanh: bool = True
    skip_layer: bool = True
    batchnorm: bool = True
    feature_learning: bool = True   # adds loss_fl + loss_fc
    geometric_weight: bool = False
    dynamic_weighting: bool = False
    pn_loss: bool = False
    margin: float = 0.5
    hard_negatives: bool = True
    # feature-consistency weight: 'geow' (zero on the observed face,
    # decaying away from it) or 'uniform'; fc_scale multiplies the loss
    fc_weight_mode: str = "geow"
    fc_scale: float = 1.0
    # the 'f' head's target: 'netf' (the frozen feature net) or
    # 'photometric' (pipeline/oracle.py's procedural descriptors)
    fc_target: str = "netf"
    w_depth: float = 1.0
    learning_rate: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    ngf: int = 64
    base_width: int = 64
    internal_size: tuple = (224, 224)
    # netF with folded running-stats BatchNorm
    feat_frozen_bn: bool = False
    dtype: Any = None    # compute dtype (torch.bfloat16 on the card)

    @property
    def layout(self) -> ChannelLayout:
        return ChannelLayout(self.output_type, self.snumclass,
                             self.feature_dim)


class CompletionDraws(NamedTuple):
    """use_type1: 0-d bool, the contrastive loss reads the type-1 rows;
    negatives: its `losses.NegativeDraws`."""
    use_type1: torch.Tensor
    negatives: losses.NegativeDraws


def build_models(cfg: CompletionTrainConfig):
    net_g = SCNet(output_type=cfg.output_type, snumclass=cfg.snumclass,
                  feature_dim=cfg.feature_dim, ngf=cfg.ngf,
                  batchnorm=cfg.batchnorm, skip_layer=cfg.skip_layer,
                  use_tanh=cfg.use_tanh, dtype=cfg.dtype,
                  internal_size=tuple(cfg.internal_size))
    net_f = Resnet18_8s(num_input=7, feature_dim=cfg.feature_dim,
                        use_tanh=cfg.use_tanh, base_width=cfg.base_width,
                        dtype=cfg.dtype, frozen_bn=cfg.feat_frozen_bn)
    return net_g, net_f


def init_state(cfg: CompletionTrainConfig, device="cuda", seed: int = 0,
               net_f=None) -> TrainState:
    """net_f: the trained, frozen feature net (a fresh one from `seed` if
    omitted: fine for tests, not for real training)."""
    net_g, fresh_f = init_models(lambda: build_models(cfg), seed)
    net_f = (fresh_f if net_f is None else net_f).to(device)
    net_f.requires_grad_(False)
    net_g = net_g.to(device)
    opt = make_optimizer(net_g.parameters(), cfg.learning_rate, cfg.b1,
                         cfg.b2)
    return TrainState({"net_g": net_g}, opt, root="net_g",
                      frozen={"net_f": net_f})


def draw(cfg, batch, generator=None) -> CompletionDraws:
    n, k = batch["denseCorres"]["idx_src"].shape[:2]
    h, w = batch["rgb"].shape[2:4]
    dev = batch["rgb"].device
    use_type1 = torch.rand((), generator=generator, device=dev) < 0.5
    return CompletionDraws(use_type1, losses.draw_negatives(
        n, k, h, w, cfg.hard_negatives, generator=generator, device=dev))


def _assemble_views(batch, cfg: CompletionTrainConfig):
    """The 4n-row input stack and the broadcast loss weights."""
    n = batch["rgb"].shape[0]
    complete = complete_views(batch)
    view, mask, geow = masking.apply_mask(complete, cfg.mask_method,
                                          variant="train")
    view = torch.cat([view, mask], dim=-1)            # [2n, H, W, 8]
    warped = pack(batch, "proj_view8")                # t2s, then s2t
    type0 = torch.cat([view, torch.zeros_like(view)], dim=-1)
    type1 = torch.cat([view, warped], dim=-1)
    view4n = torch.cat([type0, type1], dim=0)         # [4n, H, W, 16]

    def rep2(x):
        return torch.cat([x, x], dim=0)

    data_mask = rep2(pack(batch, "dataMask"))
    geow4 = rep2(geow[..., :1])
    if cfg.dynamic_weighting:
        box = rep2(pack(batch, "proj_box")[..., None])
        dynamic_w = torch.where(box == 0, 0.2, 1.0)
    else:
        dynamic_w = 1.0
    if cfg.geometric_weight:
        total_weight = geow4 * dynamic_w * data_mask
    else:
        total_weight = dynamic_w * data_mask
    segm4 = rep2(pack(batch, "segm")) if "segm" in batch else None
    return dict(n=n, view4n=view4n, complete4=rep2(complete),
                data_mask=data_mask, geow4=geow4,
                total_weight=total_weight, segm4=segm4)


def loss_fn(net_g, net_f, batch, draws: CompletionDraws,
            cfg: CompletionTrainConfig):
    """Returns (total, metrics of 0-d tensors)."""
    a = _assemble_views(batch, cfg)
    n = a["n"]
    fake = net_g(a["view4n"])                         # [4n, H, W, C]
    sp = cfg.layout.spans
    metrics = {}
    total = 0.0
    gt = {"rgb": a["complete4"][..., 0:3], "n": a["complete4"][..., 3:6],
          "d": a["complete4"][..., 6:7]}
    for m in ("rgb", "n", "d"):
        if m in sp:
            lo, hi = sp[m]
            l = losses.masked_l1(fake[..., lo:hi], gt[m], a["total_weight"])
            metrics[f"loss_{m}"] = l
            total = total + (cfg.w_depth * l if m == "d" else l)
    if "s" in sp and a["segm4"] is not None:
        lo, hi = sp["s"]
        l = losses.weighted_ce(fake[..., lo:hi], a["segm4"],
                               a["total_weight"])
        metrics["loss_s"] = l
        total = total + l

    if cfg.feature_learning and "f" in sp:
        lo, hi = sp["f"]
        teacher_in = torch.cat([a["complete4"][:2 * n]] * 2, dim=0)
        with torch.no_grad():
            if cfg.fc_target == "photometric":
                fakec = procedural_descriptors(teacher_in[..., 0:3], hi - lo)
            else:
                fakec = net_f(teacher_in)
        fc_w = a["geow4"] if cfg.fc_weight_mode == "geow" else \
            torch.ones_like(a["geow4"])
        loss_fc = cfg.fc_scale * losses.feature_consistency_loss(
            fake[..., lo:hi], fakec, a["data_mask"], fc_w)
        t1 = draws.use_type1
        feat_s = torch.where(t1, fake[2 * n:3 * n, ..., lo:hi],
                             fake[0:n, ..., lo:hi])
        feat_t = torch.where(t1, fake[3 * n:4 * n, ..., lo:hi],
                             fake[n:2 * n, ..., lo:hi])
        loss_fl, loss_pos, loss_neg = losses.contrastive_loss(
            feat_s, feat_t, batch["denseCorres"], draws.negatives,
            cfg.margin, hard_negatives=cfg.hard_negatives)
        metrics.update(loss_fc=loss_fc, loss_fl=loss_fl,
                       loss_fl_pos=loss_pos, loss_fl_neg=loss_neg,
                       used_type1=t1.to(torch.float32))
        total = total + loss_fl + loss_fc

    if cfg.pn_loss:
        lo_n, lo_d = sp["n"][0], sp["d"][0]
        depth_gt = pack(batch, "depth")
        loss_pn = losses.plane_normal_loss(
            torch.cat([depth_gt, depth_gt], dim=0),
            fake[..., lo_n:lo_n + 3], fake[..., lo_d] * 4.0, cfg.dataset)
        metrics["loss_pn"] = loss_pn
        total = total + loss_pn

    metrics["loss"] = total
    return total, metrics


def train_step(state: TrainState, batch, draws: CompletionDraws,
               cfg: CompletionTrainConfig) -> dict:
    """One Adam step in place; returns the detached metrics and the
    gradient norm."""
    state.optimizer.zero_grad(set_to_none=False)
    with record_function("rp.forward"):
        total, metrics = loss_fn(state.models["net_g"],
                                 state.frozen["net_f"], batch, draws, cfg)
    with record_function("rp.backward"):
        total.backward()
    with record_function("rp.adam"):
        metrics["grad_norm"] = grad_norm(state.parameters())
        state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def eval_metrics(state: TrainState, batch, draws: CompletionDraws,
                 cfg: CompletionTrainConfig) -> dict:
    with torch.no_grad():
        return loss_fn(state.models["net_g"], state.frozen["net_f"], batch,
                       draws, cfg)[1]
