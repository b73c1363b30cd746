"""Shared CLI plumbing: the training argument surface and dataset
resolution of `relativepose_tpu/cli/common.py`, with `--device` (default
cuda), `parse_internal_size` for the evaluation CLI, and `run_ranks`,
which runs a training CLI on `--num_devices` ranks."""

from __future__ import annotations

import argparse
import os

from relativepose_tpu_torch import config


def synthetic_scene_kwargs(args) -> dict:
    """v4 scene knobs -> SyntheticPairs kwargs (absent flags = v3)."""
    return dict(ramp_weight=getattr(args, "ramp_weight", 0.35),
                n_clutter=getattr(args, "n_clutter", 0))


def add_common_training_args(p: argparse.ArgumentParser):
    p.add_argument("--exp", type=str, required=False, default="dev",
                   help="experiment name (experiments/exp_<name>)")
    p.add_argument("--dataList", type=str, default="matterport3dv1",
                   help="suncgv3 | scannetv1 | matterport3dv1 | synthetic")
    p.add_argument("--listPath", type=str, default=None,
                   help="path to the dataList .npy (real datasets)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_epoch", type=int, default=1000)
    p.add_argument("--maskMethod", type=str, default="second")
    p.add_argument("--outputType", type=str, default="rgbdnsf")
    p.add_argument("--snumclass", type=int, default=None)
    p.add_argument("--featureDim", type=int, default=32)
    p.add_argument("--skipLayer", type=int, default=1)
    p.add_argument("--useTanh", type=int, default=1)
    p.add_argument("--batchnorm", type=int, default=1)
    p.add_argument("--featurelearning", type=int, default=0)
    p.add_argument("--GeometricWeight", type=int, default=0)
    p.add_argument("--dynamicWeighting", type=int, default=0)
    p.add_argument("--pnloss", type=int, default=0)
    p.add_argument("--D", type=float, default=0.5)
    p.add_argument("--hardNegatives", type=int, default=1,
                   help="mine hardest contrastive negatives (0 = the "
                        "reference's uniform-random negatives)")
    p.add_argument("--ramp_weight", type=float, default=0.35,
                   help="synthetic v4 scene knob: position-ramp texture "
                        "coefficient (0.35 = v3 scenes, 0 = no globally "
                        "localizing paint; data/synthetic.py::_texture)")
    p.add_argument("--n_clutter", type=int, default=0,
                   help="synthetic v4 scene knob: interior occluders per "
                        "room (boxes/cylinders -> occlusion + normals off "
                        "the axis lattice)")
    p.add_argument("--view_detail_jitter", type=int, default=0,
                   help="synthetic-data augmentation: render each view of "
                        "a pair with a different fine-texture seed so "
                        "descriptors learn cross-view-stable cues "
                        "(data/synthetic.py::_texture)")
    p.add_argument("--fcWeightMode", type=str, default="geow",
                   choices=["geow", "uniform"],
                   help="feature-consistency loss weight: 'geow' = the "
                        "reference's boundary-decaying weight (mainPano"
                        "Completion2view.py:544); 'uniform' = dataMask "
                        "everywhere (supervises hallucinated descriptors "
                        "far from the observed boundary equally)")
    p.add_argument("--fcScale", type=float, default=1.0,
                   help="feature-consistency loss multiplier")
    p.add_argument("--fcTarget", type=str, default="netf",
                   choices=["netf", "photometric"],
                   help="'f'-head regression target: frozen netF (the "
                        "reference design) or procedural photo-consistent "
                        "descriptors (see train/completion.py)")
    p.add_argument("--wDepth", type=float, default=1.0,
                   help="depth-reconstruction L1 multiplier (completed "
                        "depth feeds the solver's 0.08 m pairwise-distance "
                        "filters, rpmodule.py:399-404)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--rm", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--bf16", type=int, default=1,
                   help="bfloat16 compute for the conv nets")
    p.add_argument("--num_devices", type=int, default=None,
                   help="ranks, one card each (default 1): a data x "
                        "model mesh (train/mesh.py)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model-axis size: wide conv kernels split over "
                        "this many ranks")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, or cpu for tests)")
    p.add_argument("--internal_size", type=str, default="224x224",
                   help="SCNet internal working resolution HxW (the "
                        "reference hardcodes 224, mymodel.py:261; smaller "
                        "settings trade fidelity for throughput)")
    p.add_argument("--ngf", type=int, default=64,
                   help="SCNet width (shrink for CPU tests)")
    p.add_argument("--base_width", type=int, default=64,
                   help="ResNet stem width (shrink for CPU tests)")
    return p


def parse_internal_size(s: str) -> tuple:
    """'224x224' / '160,320' -> (224, 224) / (160, 320)."""
    parts = s.replace("x", ",").split(",")
    hw = tuple(int(p) for p in parts)
    assert len(hw) == 2 and all(v % 32 == 0 and v >= 64 for v in hw), (
        f"internal_size must be two multiples of 32 >= 64, got {s}")
    return hw


def resolve_dataset(args):
    name = args.dataList
    if "synthetic" in name:
        ds = getattr(args, "synthetic_family", "suncg")
    else:
        ds = config.canonical_dataset(name)
    if args.snumclass is None:
        args.snumclass = config.NUM_CLASSES[ds]
    mask = "kinect" if ds == "scannet" else args.maskMethod
    return ds, mask


def resolve_device(args):
    """The torch device of --device.  A CUDA device that is not there is
    an error, never a fall-back to the CPU.  Also turns TF32 off (the
    geometry and the losses' products stay f32)."""
    import torch

    from relativepose_tpu_torch.pipeline.recurrent import set_numerics
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device")
    set_numerics()
    return device


def run_ranks(args, rank_fn):
    """Run rank_fn(args, dirs) -> checkpoint path on `--num_devices`
    ranks (1 by default): the experiment directory is made once, here;
    with more than one rank each is a process of its own, joined over
    NCCL (cuda) or gloo (cpu) through a FileStore in that directory, and
    the newest checkpoint's path is returned after all have ended."""
    import torch

    from relativepose_tpu_torch.train import mesh
    from relativepose_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        require_npz,
    )
    from relativepose_tpu_torch.utils.experiment import ExperimentDirs

    world = args.num_devices or 1
    if world % args.model_parallel:
        raise ValueError(f"--num_devices {world} is not a multiple of "
                         f"--model_parallel {args.model_parallel}")
    data = world // args.model_parallel
    if args.batch_size % data:
        raise ValueError(f"--batch_size {args.batch_size} does not split "
                         f"over {data} data-parallel ranks")
    if getattr(args, "feat_ckpt", None):
        require_npz(args.feat_ckpt)   # before any rank starts
    dirs = ExperimentDirs(args.exp, rm=args.rm, resume=args.resume)
    if world == 1:
        return rank_fn(args, dirs)
    if torch.device(args.device).type == "cuda" and \
            torch.cuda.device_count() < world:
        raise RuntimeError(f"--num_devices {world}, but torch sees "
                           f"{torch.cuda.device_count()} CUDA devices")
    store = os.path.join(os.path.abspath(dirs.exp_dir), "rendezvous")
    if os.path.exists(store):
        os.remove(store)
    mesh.spawn(_rank_main, world, (world, rank_fn, args, dirs, store))
    ckpt = CheckpointManager(dirs.params_dir)
    return ckpt.path(ckpt.all_steps()[-1])


def _rank_main(rank, world, rank_fn, args, dirs, store):
    import torch
    import torch.distributed as dist

    from relativepose_tpu_torch.train import mesh
    mesh.init_distributed(rank, world, store, torch.device(args.device).type)
    try:
        rank_fn(args, dirs)
    finally:
        dist.destroy_process_group()
