"""One completion step and one sharded evaluation on a data x model mesh.

The port's counterpart of `__graft_entry__.py::dryrun_multichip`, at its
size by default (SCNet ngf 16, whose bottleneck kernel has the 256 output
channels the tensor-parallel rule needs; the feature net at width 8): a
global batch of synthetic suncg pairs goes through `completion.train_step`
on the mesh of `train/mesh.py`, then an SCNet with weights from a fixed
seed estimates the pairs' poses with `mesh.sharded_pose_estimator` (the
same weights on every rank and in every run, so the poses show the
sharding alone).  `step` runs it in the
calling process, on a process group if one is initialised (as
`one_rank_step` does) or on none; `dryrun` spawns `world` ranks over gloo
(CPU) or NCCL (cards) and returns rank 0's result.  Either returns the
step's metrics, the updated parameters as the full Flax-keyed tree, and
the poses, so a test can hold the mesh to the 1-rank step.

    python -m relativepose_tpu_torch.train.mesh_dryrun --world 4 \
        --model_parallel 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.data import device_store as dstore
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.train import completion, mesh
from relativepose_tpu_torch.train.state import init_models


def step(n_pairs: int = 2, ngf: int = 16, base_width: int = 8,
         model_parallel: int = 1, device="cpu", dtype=None, batch_seed=1,
         eval_pairs: bool = True):
    """The dry run in this process.  Returns (metrics {name: float},
    updated SCNet tree {flat name: f32 array}, poses [n_pairs, 4, 4] or
    None, sharded parameter names)."""
    from relativepose_tpu_torch.match.keypoints import KeypointConfig
    from relativepose_tpu_torch.match.solver import (
        SolverHyperParams,
        SolverStaticConfig,
    )
    from relativepose_tpu_torch.pipeline import PipelineConfig
    from relativepose_tpu_torch.pipeline.recurrent import make_scnet_fn

    device = torch.device(device)
    world = torch.distributed.get_world_size() \
        if torch.distributed.is_initialized() else 1
    m = mesh.make_mesh(world, model_parallel)
    cfg = completion.CompletionTrainConfig(
        feature_learning=True, geometric_weight=True, ngf=ngf,
        base_width=base_width, dtype=dtype)
    state = completion.init_state(cfg, device, seed=0)
    mesh.shard_train_state(state, m, tensor_parallel=m.model > 1)
    sharded = sorted(name for name, p in state.models["net_g"].
                     named_parameters() if getattr(p, "shard", None))

    source = dsets.SyntheticPairs("suncg", n=n_pairs, seed=0,
                                  full_frames=False)
    store = dstore.DeviceStore(source, device=device, with_full_frames=False)
    keep = (lambda tree: mesh.shard_batch(tree, m)) if m.data > 1 else None
    batch = next(iter(dstore.ResidentLoader(store, n_pairs, "suncg",
                                            keep=keep)))
    gen = torch.Generator(device=device).manual_seed(batch_seed)
    draws = mesh.shard_batch(completion.draw(cfg, batch, gen, n=n_pairs), m)
    metrics = completion.train_step(state, batch, draws, cfg)
    metrics = {k: float(v) for k, v in metrics.items()}
    with mesh.gathered(state):
        tree = convert.flatten_params(state.params_tree())

    poses = None
    if eval_pairs:
        net = init_models(lambda: SCNet(ngf=ngf, dtype=dtype), seed=1)
        net = net.to(device).eval()
        pcfg = PipelineConfig(
            dataset="suncg", alter_steps=1,
            keypoints=KeypointConfig(n_detect=32, n_match=16, n_random=8),
            solver=SolverStaticConfig(power_iters=5))
        items = [source[i] for i in range(n_pairs)]
        pick = {v: {k: np.stack([np.asarray(it[v][k]) for it in items])
                    for k in ("rgb", "norm", "depth")}
                for v in ("data_s", "data_t")}
        est = mesh.sharded_pose_estimator(make_scnet_fn(net), pcfg, m,
                                          device)
        poses = est(pick["data_s"], pick["data_t"], SolverHyperParams(),
                    np.arange(n_pairs) + 100).cpu().numpy()
    return metrics, tree, poses, sharded


def one_rank_step(store_dir: str, device_type: str = "cpu", **kwargs):
    """`step` in this process on a 1-rank process group (gloo or NCCL)
    whose FileStore lives in `store_dir`."""
    mesh.init_distributed(0, 1, os.path.join(store_dir, "store"),
                          device_type)
    try:
        return step(device=device_type, **kwargs)
    finally:
        torch.distributed.destroy_process_group()


def _rank(rank, world, model_parallel, store_path, out_path, device_type,
          kwargs):
    mesh.init_distributed(rank, world, store_path, device_type)
    try:
        metrics, tree, poses, sharded = step(
            model_parallel=model_parallel,
            device="cuda" if device_type == "cuda" else "cpu", **kwargs)
        if rank == 0:
            np.savez(out_path, poses=np.zeros(()) if poses is None else poses,
                     sharded=np.asarray(sharded),
                     **{f"metric/{k}": v for k, v in metrics.items()},
                     **{f"param/{k}": v for k, v in tree.items()})
    finally:
        torch.distributed.destroy_process_group()


def dryrun(world: int, model_parallel: int = 1, device_type: str = "cpu",
           **kwargs):
    """`step` on `world` spawned ranks; returns rank 0's result."""
    with tempfile.TemporaryDirectory(prefix="rp_mesh_") as tmp:
        out = os.path.join(tmp, "rank0.npz")
        mesh.spawn(_rank, world, (world, model_parallel,
                                  os.path.join(tmp, "store"), out,
                                  device_type, kwargs))
        with np.load(out) as z:
            metrics = {k[7:]: float(z[k]) for k in z.files
                       if k.startswith("metric/")}
            tree = {k[6:]: z[k] for k in z.files if k.startswith("param/")}
            poses = z["poses"]
            sharded = [str(s) for s in z["sharded"]]
    return metrics, tree, (None if poses.ndim == 0 else poses), sharded


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--n_pairs", type=int, default=2,
                   help="global batch (a multiple of the data size)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "float64", "bfloat16"],
                   help="the networks' compute dtype")
    args = p.parse_args(argv)
    kw = dict(dtype=getattr(torch, args.dtype), n_pairs=args.n_pairs)
    with tempfile.TemporaryDirectory(prefix="rp_mesh_") as tmp:
        ref = one_rank_step(tmp, args.device, **kw)
    got = dryrun(args.world, args.model_parallel, args.device, **kw)
    d_par = max(float(np.abs(got[1][k] - ref[1][k]).max()) for k in ref[1])
    d_pose = float(np.abs(got[2] - ref[2]).max())
    print(f"mesh {args.world // args.model_parallel} x {args.model_parallel}"
          f" ({args.dtype}, {args.n_pairs} pairs, {args.device}): loss "
          f"{got[0]['loss']:.8f} (1 rank {ref[0]['loss']:.8f}), max |param "
          f"diff| {d_par:.3g}, max |pose diff| {d_pose:.3g}, {len(got[3])} "
          f"kernels split over the model axis", flush=True)


if __name__ == "__main__":
    main()
