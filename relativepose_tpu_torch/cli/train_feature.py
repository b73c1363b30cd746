"""Feature-network training driver (the flags of
`relativepose_tpu.cli.train_feature`).

Synthetic pairs on the card:
    python -m relativepose_tpu_torch.cli.train_feature --exp feat_suncg \
        --dataList synthetic --synthetic_family suncg

Real datasets: --dataList suncgv3 --listPath data/dataList/suncgv3.npy in
the original on-disk layout.  `--device cpu` runs on the CPU.  Each
checkpoint is `experiments/exp_<name>/params/checkpoint_%04d.npz`, in
the JAX package's npz format (`utils/checkpoint.py`); scalars go to
`experiments/exp_<name>/tensorboard/scalars.jsonl`.

`--num_devices N [--model_parallel M]` trains on N ranks, one card each (or
N CPU processes with `--device cpu`): one global step of `--batch_size`
pairs over an (N / M) x M data x model mesh (`train/mesh.py`).  Rank 0
logs and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import os
import queue
import threading

import numpy as np
import torch

from relativepose_tpu_torch.cli.common import (
    add_common_training_args,
    resolve_dataset,
    resolve_device,
    run_ranks,
    synthetic_scene_kwargs,
)
from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.data import device_store as dstore
from relativepose_tpu_torch.data import pipeline as dpipe
from relativepose_tpu_torch.train import feature, mesh
from relativepose_tpu_torch.utils.callbacks import (
    CallbackLoc,
    OnceCallback,
    PeriodicCallback,
)
from relativepose_tpu_torch.utils.checkpoint import CheckpointManager
from relativepose_tpu_torch.utils.experiment import parameters_count
from relativepose_tpu_torch.utils.log import AverageMeter, FileLogger
from relativepose_tpu_torch.utils.metrics_writer import MetricsWriter
from relativepose_tpu_torch.utils.trainer import Trainer


def make_source(args, split: str, dataset: str):
    if "synthetic" in args.dataList:
        if args.debug:
            n = 64
        else:
            n = getattr(args, "synthetic_n", None) or 2048
            if split != "train":
                n = max(64, n // 8)
        return dsets.SyntheticPairs(
            dataset, n=n, seed=0 if split == "train" else 10_000,
            view_detail_jitter=bool(getattr(args, "view_detail_jitter", 0)),
            full_frames=False,  # the training steps never read them
            **synthetic_scene_kwargs(args))
    return dsets.PanoPairDataset(dataset, split, args.listPath)


def batch_iterator(source, args, dataset: str, seed: int, device,
                   keep=None):
    """The streaming loader (real datasets, or --device_data 0).

    A host thread reads, encodes (the on-disk precision: uint8 rgb, int8
    normals, uint16 millimetres) and stacks one batch ahead; the consumer
    uploads it and decodes and augments it on the device.  With `keep` (a
    data-parallel rank) the global batch is read and drawn for, and `keep`
    picks this rank's rows."""
    rng = np.random.RandomState(seed)
    fields = (("rgb", dstore.encode_rgb), ("norm", dstore.encode_norm),
              ("depth", dstore.encode_depth),
              ("segm", lambda a: np.asarray(a, np.uint8)),
              ("pose", lambda a: np.asarray(a, np.float32)))

    def host_batches():
        order = rng.permutation(len(source))
        for lo in range(0, len(order) - args.batch_size + 1,
                        args.batch_size):
            items = [source[int(i)] for i in order[lo:lo + args.batch_size]]
            yield {f: np.stack([np.stack([enc(it["data_s"][f]),
                                          enc(it["data_t"][f])])
                                for it in items])
                   for f, enc in fields}

    class _Loader:
        def __iter__(self):
            q = queue.Queue(maxsize=2)
            end = object()

            def worker():
                try:
                    for b in host_batches():
                        q.put(b)
                except Exception as e:  # surfaced in the consumer
                    q.put(e)
                finally:
                    q.put(end)

            threading.Thread(target=worker, daemon=True).start()
            gen = torch.Generator(device=device).manual_seed(
                int(rng.randint(2 ** 31)))
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                t = {k: dstore.as_tensor(v, device) for k, v in item.items()}
                rgb, norm, depth, segm = dstore.decode_batch(
                    t["rgb"], t["norm"], t["depth"], t["segm"])
                batch = (rgb, norm, depth, t["pose"], segm,
                         dpipe.draw_pair_batch(depth, dataset, gen))
                if keep is not None:
                    batch = keep(batch)
                yield dpipe.assemble_pair_batch(*batch, dataset)

    return _Loader()


def make_loaders(args, dataset: str, device, keep=None):
    """(train, val) loaders: device-resident for synthetic sets (uploaded
    once, every batch gathered and augmented on the device), streaming
    for real datasets or --device_data 0.  `keep`: a data-parallel rank's
    row picker (`mesh.shard_batch`), or None."""
    train_src = make_source(args, "train", dataset)
    val_src = make_source(args, "test", dataset)
    if getattr(args, "device_data", 1) and "synthetic" in args.dataList:
        stores = [dstore.DeviceStore(src, log=print, device=device,
                                     with_full_frames=False)
                  for src in (train_src, val_src)]
        return tuple(dstore.ResidentLoader(s, args.batch_size, dataset,
                                           seed=i, keep=keep)
                     for i, s in enumerate(stores))
    return (batch_iterator(train_src, args, dataset, 0, device, keep),
            batch_iterator(val_src, args, dataset, 1, device, keep))


def add_driver_args(p):
    add_common_training_args(p)
    p.add_argument("--synthetic_family", type=str, default="suncg")
    p.add_argument("--synthetic_n", type=int, default=None,
                   help="synthetic train-set size (val = n/8)")
    p.add_argument("--train_duration", type=float, default=300.0)
    p.add_argument("--save_every", type=int, default=5)
    p.add_argument("--device_data", type=int, default=1,
                   help="keep the synthetic set on the device (0 = stream)")
    p.add_argument("--log_every", type=int, default=10,
                   help="metric fetch cadence (each fetch synchronises)")


def run(args, dataset, device, state, dirs, logf, step_fn, m):
    """The epoch loop shared by both training CLIs: resume, placement
    on the mesh `m`, loaders, metric logging every --log_every steps,
    checkpoints every --save_every epochs and at the end (rank 0 logs and
    writes; every rank takes part in gathering split parameters).
    step_fn(batch, mode) -> dict of 0-d tensors.  Returns the newest
    checkpoint's path on rank 0, None on the others."""
    ckpt = CheckpointManager(dirs.params_dir, keep=3)
    start_epoch = 0
    if args.resume:
        state, ok = ckpt.restore_into(state)
        if ok:
            # resume the epoch counter, or keep-N would discard every new
            # checkpoint (their numbers would sort below the old ones)
            start_epoch = ckpt.all_steps()[-1]
        logf("resume: " + (f"ok, from epoch {start_epoch}" if ok
                           else "no checkpoint found"))
    mesh.shard_train_state(state, m, tensor_parallel=m.model > 1)
    meter = AverageMeter()
    tb = MetricsWriter(os.path.join(dirs.exp_dir, "tensorboard")) \
        if m.is_main else None
    count = {"n": 0}

    def logged_step(batch, mode):
        metrics = step_fn(batch, mode)
        count["n"] += 1
        if count["n"] % args.log_every and mode == "train":
            return {}
        metrics = {k: float(v) for k, v in metrics.items()}
        meter.update(metrics["loss"])
        if tb is not None:
            tb.scalars("loss", {f"{mode}_{k}": v
                                for k, v in metrics.items()}, count["n"])
        return metrics

    def save_cb(context):
        with mesh.gathered(state):
            if m.is_main:
                ckpt.save(context["epoch"], state)
        logf(f"epoch {context['epoch']}: checkpoint saved; "
             f"avg loss {meter.avg:.6f}")

    keep = (lambda tree: mesh.shard_batch(tree, m)) if m.data > 1 else None
    train_loader, val_loader = make_loaders(args, dataset, device, keep)
    agree = (lambda go: mesh.all_agree(go, device)) if m.data * m.model > 1 \
        else None
    Trainer(step_fn=logged_step, train_loader=train_loader,
            val_loader=val_loader, max_epoch=args.max_epoch,
            train_duration=args.train_duration, epoch=start_epoch,
            agree=agree, verbose=m.is_main,
            callbacks=[PeriodicCallback(CallbackLoc.epoch_end,
                                        args.save_every, save_cb),
                       OnceCallback(CallbackLoc.train_end, save_cb)]).run()
    return ckpt.path(ckpt.all_steps()[-1]) if m.is_main else None


def rank_logger(dirs, m):
    """Rank 0's FileLogger; the other ranks log nothing."""
    return FileLogger(dirs.log_path) if m.is_main else (lambda msg: None)


def _train(args, dirs):
    dataset, _ = resolve_dataset(args)
    device = resolve_device(args)
    m = mesh.make_mesh(args.num_devices, args.model_parallel)
    logf = rank_logger(dirs, m)
    cfg = feature.FeatureTrainConfig(
        snumclass=args.snumclass, feature_dim=args.featureDim,
        use_tanh=bool(args.useTanh), margin=args.D,
        hard_negatives=bool(args.hardNegatives),
        featlearn_segm=bool(getattr(args, "featlearnSegm", 0)),
        base_width=args.base_width,
        dtype=torch.bfloat16 if args.bf16 else None)
    state = feature.init_state(cfg, device, seed=0)
    if m.is_main:
        parameters_count(state.models["net_f"], "netF")
    gen = torch.Generator(device=device).manual_seed(1)

    def step_fn(batch, mode):
        # drawn for the global batch, as on one rank; this rank's rows kept
        negatives = mesh.shard_batch(feature.draw_negatives(
            cfg, batch, gen, n=batch["rgb"].shape[0] * m.data), m)
        if mode == "train":
            return feature.train_step(state, batch, negatives, cfg)
        return feature.eval_metrics(state, batch, negatives, cfg)

    return run(args, dataset, device, state, dirs, logf, step_fn, m)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_driver_args(p)
    return run_ranks(p.parse_args(argv), _train)


if __name__ == "__main__":
    main()
