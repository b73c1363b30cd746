"""Pano-completion training driver (the flags of
`relativepose_tpu.cli.train_completion`).

    python -m relativepose_tpu_torch.cli.train_completion --exp comp_suncg \
        --dataList synthetic --synthetic_family suncg --featurelearning 1 \
        --feat_ckpt experiments/exp_feat_suncg/params/checkpoint_0001.npz

`--feat_ckpt` loads the frozen feature net from an npz weight file with a
`net_f` tree: a checkpoint of the feature CLI of either package.
`--torch_feat_ckpt` loads it from the original repository's state dict
(`utils/torch_import.py`), with its BatchNorm running statistics folded
into a frozen affine.  Orbax checkpoint directories are not read
(`utils/checkpoint.py::restore_params`).  `--num_devices` and
`--model_parallel` as in `cli/train_feature.py`.
"""

from __future__ import annotations

import argparse

import torch

from relativepose_tpu_torch.cli import common, train_feature
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.resnet import Resnet18_8s
from relativepose_tpu_torch.train import completion, mesh
from relativepose_tpu_torch.utils import torch_import
from relativepose_tpu_torch.utils.checkpoint import restore_params
from relativepose_tpu_torch.utils.experiment import parameters_count


def _train(args, dirs):
    dataset, mask_method = common.resolve_dataset(args)
    device = common.resolve_device(args)
    m = mesh.make_mesh(args.num_devices, args.model_parallel)
    logf = train_feature.rank_logger(dirs, m)
    cfg = completion.CompletionTrainConfig(
        dataset=dataset, mask_method=mask_method,
        output_type=args.outputType, snumclass=args.snumclass,
        feature_dim=args.featureDim, use_tanh=bool(args.useTanh),
        skip_layer=bool(args.skipLayer), batchnorm=bool(args.batchnorm),
        feature_learning=bool(args.featurelearning),
        geometric_weight=bool(args.GeometricWeight),
        dynamic_weighting=bool(args.dynamicWeighting),
        pn_loss=bool(args.pnloss), margin=args.D,
        hard_negatives=bool(args.hardNegatives),
        fc_weight_mode=args.fcWeightMode, fc_scale=args.fcScale,
        fc_target=args.fcTarget, w_depth=args.wDepth,
        ngf=args.ngf, base_width=args.base_width,
        internal_size=common.parse_internal_size(args.internal_size),
        feat_frozen_bn=bool(args.torch_feat_ckpt),
        dtype=torch.bfloat16 if args.bf16 else None)

    net_f = None
    if args.torch_feat_ckpt or args.feat_ckpt:
        net_f = Resnet18_8s(num_input=7, feature_dim=cfg.feature_dim,
                            use_tanh=cfg.use_tanh, base_width=cfg.base_width,
                            dtype=cfg.dtype, frozen_bn=cfg.feat_frozen_bn)
        if args.torch_feat_ckpt:
            torch_import.load_resnet18_8s(
                torch_import.load_torch_state_dict(args.torch_feat_ckpt),
                net_f)
        else:
            convert.load_flax_params(
                net_f, restore_params(args.feat_ckpt)["params"]["net_f"])
        logf("loaded frozen netF weights")
    state = completion.init_state(cfg, device, seed=0, net_f=net_f)
    if m.is_main:
        parameters_count(state.models["net_g"], "netG")
    gen = torch.Generator(device=device).manual_seed(1)

    def step_fn(batch, mode):
        # drawn for the global batch, as on one rank; this rank's rows kept
        draws = mesh.shard_batch(completion.draw(
            cfg, batch, gen, n=batch["rgb"].shape[0] * m.data), m)
        if mode == "train":
            return completion.train_step(state, batch, draws, cfg)
        return completion.eval_metrics(state, batch, draws, cfg)

    return train_feature.run(args, dataset, device, state, dirs, logf,
                             step_fn, m)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    train_feature.add_driver_args(p)
    p.add_argument("--feat_ckpt", type=str, default=None,
                   help="frozen feature net: an npz weight file")
    p.add_argument("--torch_feat_ckpt", type=str, default=None,
                   help="the original repository's netF state dict "
                        "(.pth.tar), converted on load "
                        "(utils/torch_import.py)")
    return common.run_ranks(p.parse_args(argv), _train)


if __name__ == "__main__":
    main()
