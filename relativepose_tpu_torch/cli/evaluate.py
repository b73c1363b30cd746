"""Evaluation driver of the port (the protocol of the original
evaluation.py), with the flags of `relativepose_tpu.cli.evaluate`.

Synthetic scenes, oracle completion, on the card:
    python -m relativepose_tpu_torch.cli.evaluate --dataList synthetic \
        --synthetic_family scannet --method ours --maxIter 100

With trained completion weights (an npz weight file such as the JAX
package's `data/pretrained/suncg.comp_ft.npz`):
    python -m relativepose_tpu_torch.cli.evaluate --dataList synthetic \
        --method ours --comp_ckpt suncg.comp_ft.npz

With the original repository's SCNet checkpoint (a `.pth.tar` state
dict, `utils/torch_import.py`):
    python -m relativepose_tpu_torch.cli.evaluate --dataList synthetic \
        --method ours --torch_comp_ckpt suncg.comp.pth.tar

The classical methods (`--method super4pcs | gs | fgs | cgs`) register
each pair in the native library (`eval/baselines.py`).  `--device cpu`
runs everything on the CPU.  Orbax checkpoint directories are not read
(`utils/checkpoint.py::restore_params` says why).
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

from relativepose_tpu_torch import config
from relativepose_tpu_torch.config import ChannelLayout
from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.eval import harness
from relativepose_tpu_torch.match.keypoints import KeypointConfig
from relativepose_tpu_torch.match.solver import SolverStaticConfig
from relativepose_tpu_torch.pipeline import PipelineConfig


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataList", type=str, default="matterport3dv1")
    p.add_argument("--listPath", type=str, default=None)
    p.add_argument("--synthetic_family", type=str, default="suncg")
    p.add_argument("--method", type=str, default="ours",
                   choices=["ours", "ours_nc", "ours_nr", "super4pcs",
                            "fgs", "gs", "cgs"])
    p.add_argument("--sigmaDist", type=float, default=0.04)
    p.add_argument("--sigmaAngle1", type=float, default=0.2615)
    p.add_argument("--sigmaAngle2", type=float, default=0.2615)
    p.add_argument("--sigmaFeat", type=float, default=0.01)
    p.add_argument("--para", type=str, default=None,
                   help="sigma table txt (rows per recurrence step)")
    p.add_argument("--maxIter", type=int, default=1000)
    p.add_argument("--num_repeat", type=int, default=1)
    p.add_argument("--outputType", type=str, default="rgbdnsf")
    p.add_argument("--snumclass", type=int, default=None)
    p.add_argument("--featureDim", type=int, default=32)
    p.add_argument("--maskMethod", type=str, default="second")
    p.add_argument("--exp", type=str, default="eval")
    p.add_argument("--rm", action="store_true")
    p.add_argument("--entrySplit", type=int, default=None)
    p.add_argument("--batch_pairs", type=int, default=4)
    p.add_argument("--comp_ckpt", type=str, default=None,
                   help="completion weights: an npz weight file")
    p.add_argument("--torch_comp_ckpt", type=str, default=None,
                   help="the original repository's SCNet state dict "
                        "(.pth.tar), converted on load "
                        "(utils/torch_import.py)")
    p.add_argument("--eval_seed", type=int, default=20_000,
                   help="synthetic eval scene seed (train=0, val=10000 "
                        "are the training scripts' seeds)")
    p.add_argument("--ramp_weight", type=float, default=0.35,
                   help="synthetic scene knob: position-ramp coefficient of "
                        "the texture (0.35 = v3)")
    p.add_argument("--n_clutter", type=int, default=0,
                   help="synthetic scene knob: interior occluders per room")
    p.add_argument("--alterStep", type=int, default=None,
                   help="recurrence depth (default: 3 for ours, 1 for "
                        "ours_nr)")
    p.add_argument("--per_step_errors", type=int, default=0,
                   help="also record the pose error after each recurrence "
                        "step")
    p.add_argument("--step_select", type=str, default="last",
                   choices=["last", "best_score"],
                   help="'last' = the original's final step; 'best_score' "
                        "= the step with the highest solver inlier rate")
    p.add_argument("--min_score", type=float, default=0.0,
                   help="with best_score: identity pose when even the "
                        "best step's inlier rate is below this")
    p.add_argument("--refit", type=int, default=0,
                   help="tight-sigma Gaussian inlier-refit rounds after "
                        "the solver fit (SolverStaticConfig.refit_rounds)")
    p.add_argument("--trans_refine", type=int, default=0,
                   help="robust translation re-aggregation rounds with R "
                        "fixed (SolverStaticConfig.trans_refine_rounds)")
    p.add_argument("--icp", type=int, default=0,
                   help="dense projective point-to-plane ICP iterations "
                        "per recurrence step (ops/icp.py)")
    p.add_argument("--icp_dof", type=int, default=6, choices=(3, 6),
                   help="3 = translation-only polish")
    p.add_argument("--n_detect", type=int, default=None,
                   help="detector keypoint capacity per view")
    p.add_argument("--dog_threshold", type=float, default=None,
                   help="DoG response threshold on 0..255 luma")
    p.add_argument("--ngf", type=int, default=64,
                   help="SCNet width (must match the weights)")
    p.add_argument("--internal_size", type=str, default="224x224",
                   help="SCNet internal resolution HxW (must match the "
                        "weights)")
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--skipLayer", type=int, default=1,
                   help="skip connections in the completion net")
    p.add_argument("--useTanh", type=int, default=1,
                   help="tanh on the feature-map head")
    p.add_argument("--batchnorm", type=int, default=1,
                   help="batch norm in the completion net")
    p.add_argument("--representation", type=str, default="skybox",
                   choices=["skybox"])
    p.add_argument("--saveCompletion", type=int, default=1,
                   help="accepted for parity (unused)")
    p.add_argument("--force_cpu", type=int, default=1,
                   help="accepted for parity, no effect: the JAX package "
                        "uses it to keep the classical methods' bookkeeping "
                        "off the TPU; here that bookkeeping runs on "
                        "--device")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the pipeline")
    p.add_argument("--debug", action="store_true")
    p.add_argument("-l", "--log", dest="log", type=str, default="WARNING",
                   help="python logging level")
    args = p.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log.upper(), 30))
    if "synthetic" in args.dataList:
        args.family = args.synthetic_family
    else:
        args.family = config.canonical_dataset(args.dataList)
    if args.snumclass is None:
        args.snumclass = config.NUM_CLASSES[args.family]
    if args.family == "scannet":
        args.maskMethod = "kinect"
    return args


def scnet_fn_factory_from_checkpoint(args, layout: ChannelLayout):
    """The completion net of the eval pipeline: SCNet with the weights of
    an npz file (`--comp_ckpt`) or of the original repository's state dict
    (`--torch_comp_ckpt`), or the ground-truth oracle without either.

    Returns (factory, params): factory(data_s, data_t, params) ->
    scnet_fn."""
    if args.comp_ckpt or args.torch_comp_ckpt:
        from relativepose_tpu_torch.cli.common import parse_internal_size
        from relativepose_tpu_torch.models import convert
        from relativepose_tpu_torch.models.scnet import SCNet
        from relativepose_tpu_torch.pipeline.recurrent import make_scnet_fn
        from relativepose_tpu_torch.utils import torch_import
        from relativepose_tpu_torch.utils.checkpoint import restore_params
        net = SCNet(output_type=args.outputType, snumclass=args.snumclass,
                    feature_dim=args.featureDim, ngf=args.ngf,
                    internal_size=parse_internal_size(args.internal_size),
                    batchnorm=bool(args.batchnorm),
                    skip_layer=bool(args.skipLayer),
                    use_tanh=bool(args.useTanh),
                    dtype=torch.bfloat16 if args.bf16 else None)
        if args.torch_comp_ckpt:
            torch_import.load_scnet(
                torch_import.load_torch_state_dict(args.torch_comp_ckpt), net)
        else:
            convert.load_flax_params(
                net, restore_params(args.comp_ckpt)["params"])
        net = net.to(args.device).eval()
        scnet_fn = make_scnet_fn(net)

        def factory(data_s, data_t, params):
            return scnet_fn

        return factory, {}

    from relativepose_tpu_torch.pipeline.oracle import (
        make_oracle_completion_fn,
    )

    def factory(data_s, data_t, params):
        return make_oracle_completion_fn(data_s, data_t, layout)

    return factory, {}


def main(argv=None):
    args = _parse_args(argv)
    sigma_table = np.loadtxt(args.para).reshape(-1, 4) if args.para else \
        np.tile([args.sigmaAngle1, args.sigmaAngle2, args.sigmaDist,
                 args.sigmaFeat], (3, 1))
    cfg = harness.EvalConfig(
        dataset=args.family, method=args.method, exp=args.exp,
        max_iter=args.maxIter, num_repeat=args.num_repeat,
        batch_pairs=args.batch_pairs, resume=not args.rm,
        sigma_table=sigma_table,
        per_step_errors=bool(args.per_step_errors),
        alter_steps_override=args.alterStep)

    if args.method in harness.CLASSICAL_METHODS:
        from relativepose_tpu_torch.cli.common import resolve_device
        from relativepose_tpu_torch.eval import baselines
        resolve_device(args)
        runner = baselines.run_classical_eval(args, cfg)
        print(json.dumps(runner.summary()))
        return runner

    pipe_cfg = PipelineConfig(
        dataset=args.family, mask_method=args.maskMethod,
        alter_steps=cfg.alter_steps, completion=cfg.completion,
        output_type=args.outputType, snumclass=args.snumclass,
        step_select=args.step_select, min_score=args.min_score,
        icp_iters=args.icp, icp_dof=args.icp_dof,
        solver=SolverStaticConfig(refit_rounds=args.refit,
                                  trans_refine_rounds=args.trans_refine),
        feature_dim=args.featureDim, keypoints=KeypointConfig(
            **{k: v for k, v in (("n_detect", args.n_detect),
                                 ("dog_threshold", args.dog_threshold))
               if v is not None}))
    factory, scnet_params = scnet_fn_factory_from_checkpoint(
        args, pipe_cfg.layout)
    batch_fn = harness.make_batched_eval_fn(factory, cfg, pipe_cfg,
                                            args.device)
    hp = harness.hyper_params_from_table(cfg.sigma_table,
                                         alter_steps=cfg.alter_steps)

    def eval_fn(data_s, data_t, T_gt, batch_seed):
        return batch_fn(data_s, data_t, T_gt, batch_seed, scnet_params, hp)

    if "synthetic" in args.dataList:
        # held-out seed: the training scripts use seeds 0 and 10_000
        source = dsets.SyntheticPairs(args.family,
                                      n=min(args.maxIter, 1000),
                                      seed=args.eval_seed,
                                      ramp_weight=args.ramp_weight,
                                      n_clutter=args.n_clutter)
    else:
        source = dsets.PanoPairDataset(
            args.family, "test", args.listPath,
            entry_split=args.entrySplit)

    runner = harness.evaluate_stream(
        lambda: dsets.batched(source, args.batch_pairs,
                              max_items=cfg.max_iter), eval_fn, cfg)
    runner.print_stats()
    print(json.dumps(runner.summary()))
    return runner


if __name__ == "__main__":
    main()
