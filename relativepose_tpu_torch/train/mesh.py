"""Device-mesh parallelism for training and evaluation over torch.distributed.

Counterpart of `relativepose_tpu/train/mesh.py`.  The JAX package shards
one global step over a ('data', 'model') device mesh and XLA inserts the
collectives; here each rank is a process, the mesh is two sets of process
groups, and the collectives are explicit:

  * `make_mesh`: `data` x `model` ranks, rank = data index * model + model
    index (the JAX mesh's device order).  A rank's data group holds the
    ranks with its model index, its model group the ranks with its data
    index.
  * The batch is split over the data axis (`shard_batch`, with
    `pad_batch_to` for an uneven tail).  The draws of a step are made for
    the global batch from one generator state on every rank, and each rank
    keeps its rows, so a step is the 1-rank step whatever the mesh.
  * Global batch statistics: the port's `BatchNorm2d` all-reduces its
    per-channel sums and sums of squares over the data group
    (`sync_group`, set by `shard_train_state`), and the losses reduce their
    sums over it (`global_sum`), as XLA reduces them over the global batch.
    Every rank then holds the global loss, and the autograd all-reduce
    sends each rank its rows' share of the gradient, times the data size;
    DDP's average over the data group (`process_group=` that group) gives
    the global gradient.
  * Tensor parallelism (`param_sharding`): the output-channel axis of conv
    kernels with at least 256 output channels, divisible by the model
    size, is split over the model group; everything else is replicated.  A
    sharded conv computes its slice of the output channels and all-gathers
    the activation along channels (`gather_channels`); the gradient of its
    input is summed over the model group (`split_conv_input`).  Adam's moments are
    the sharded parameters' own, so they follow the shards.  Checkpoints
    gather full arrays first (`gathered`), so the npz format is the same.
  * Sharded evaluation (`sharded_pose_estimator`) splits a pair batch over
    the data group and all-gathers the poses.

Without an initialised process group, `make_mesh()` is the 1 x 1 mesh and
every helper is the identity, so one code path serves both.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map


@dataclasses.dataclass
class Mesh:
    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None    # ranks with this rank's model index
    model_group: Any = None   # ranks with this rank's data index

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def is_main(self) -> bool:
        return self.data_index == 0 and self.model_index == 0


def init_distributed(rank: int, world: int, store_path: str, device_type):
    """Join a `world`-rank process group through a FileStore at
    `store_path` (no network): NCCL for CUDA, gloo for the CPU.  On CUDA
    rank r drives card r; on the CPU the ranks share the host's cores.
    Returns the rank's device."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        device = torch.device("cpu")
    store = dist.FileStore(store_path, world)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world)
    return device


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: int = 1) -> Mesh:
    """The (data = n / model_parallel, model = model_parallel) mesh over
    the initialised process group, or the 1 x 1 mesh without one."""
    if not dist.is_initialized():
        if (n_devices or 1) != 1 or model_parallel != 1:
            raise RuntimeError("a mesh over more than one rank needs "
                               "init_distributed first")
        return Mesh()
    world = dist.get_world_size()
    n = n_devices or world
    if n != world or n % model_parallel:
        raise ValueError(f"{n} ranks (world {world}) do not form a "
                         f"data x {model_parallel} mesh")
    d, m = n // model_parallel, model_parallel
    # every rank creates every group, in the same order
    data_groups = [dist.new_group([i * m + j for i in range(d)])
                   for j in range(m)]
    model_groups = [dist.new_group([i * m + j for j in range(m)])
                    for i in range(d)]
    di, mi = divmod(dist.get_rank(), m)
    return Mesh(d, m, di, mi, data_groups[mi], model_groups[di])


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def shard_batch(batch, mesh: Mesh):
    """This rank's rows of every array with a leading axis (0-d leaves
    pass through).  The leading size must divide by the data size."""
    def rows(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        n = x.shape[0]
        if n % mesh.data:
            raise ValueError(f"{n} rows over {mesh.data} data ranks: "
                             "pad_batch_to first")
        k = n // mesh.data
        return x[mesh.data_index * k:(mesh.data_index + 1) * k]

    return tree_map(rows, batch)


def pad_batch_to(batch, multiple: int):
    """Pad the leading axis of every array with zeros to a multiple of
    `multiple` (numpy arrays and tensors; 0-d leaves pass through)."""
    def pad(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        p = (-x.shape[0]) % multiple
        if p == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((p,) + tuple(x.shape[1:]))])
        return np.pad(np.asarray(x), [(0, p)] + [(0, 0)] * (x.ndim - 1))

    return tree_map(pad, batch)


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradient
    (as `torch.distributed.nn.functional.all_reduce`, which newer torch
    deprecates)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def global_sum(x, group=None):
    """Sum of `x` over the ranks of `group` (autograd-aware); `x` itself
    without a group."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def group_size(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_agree(flag: bool, device) -> bool:
    """True when `flag` is true on every rank (the time-boxed phases end
    at the same step everywhere); `flag` without a process group."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter split along `axis` over `group`: this rank holds part
    `index` of `size`."""
    group: Any
    size: int
    index: int
    axis: int


class _GatherChannels(torch.autograd.Function):
    """All-gather along channels (dim 1) in the forward; in the backward
    this rank's slice of the incoming gradient.  Every rank of the model
    group runs the same layers after the gather on the same rows, so the
    incoming gradients are equal on all of them and the slice is the
    gradient.  (`torch.distributed.nn.functional.all_gather` sums those
    equal gradients over the group instead: `size` times the gradient, for
    the price of a reduce-scatter.)"""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(shard.size)]
        dist.all_gather(parts, x, group=shard.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        return grad.chunk(s.size, dim=1)[s.index].contiguous(), None


class _SumGradOverGroup(torch.autograd.Function):
    """The identity in the forward; in the backward the gradient summed
    over the model group: a split conv's input feeds every slice of its
    output channels, one slice per rank."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad, None


def split_conv_input(x, weight):
    """A conv's input, with the gradient summed over the model group when
    `weight` is split over one."""
    shard = getattr(weight, "shard", None)
    return x if shard is None else _SumGradOverGroup.apply(x, shard)


def gather_channels(y, weight):
    """The full activation of a conv whose `weight` may be split."""
    shard = getattr(weight, "shard", None)
    if shard is None:
        return y
    return _GatherChannels.apply(y, shard)


def _output_axes(model):
    """{parameter name: output-channel axis} of every conv kernel."""
    from relativepose_tpu_torch.models.blocks import DeconvBlock
    axes = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, DeconvBlock):
            axes[f"{pre}weight"] = 1      # [in, out, kh, kw]
        elif isinstance(mod, torch.nn.Conv2d):
            axes[f"{pre}weight"] = 0      # [out, in, kh, kw]
    return axes


def param_sharding(model, mesh: Mesh, min_shard_size: int = 256):
    """The tensor-parallel rule: {parameter name: axis} of the kernels
    whose output channels are at least `min_shard_size` and divide by the
    model size; the rest are replicated."""
    m = mesh.model
    params = dict(model.named_parameters())
    return {name: ax for name, ax in _output_axes(model).items()
            if name in params and params[name].shape[ax] % m == 0
            and params[name].shape[ax] >= min_shard_size}


def _take(t, shard):
    return t.chunk(shard.size, dim=shard.axis)[shard.index].contiguous()


def shard_module(model, mesh: Mesh):
    """Split the parameters `param_sharding` names over the model group;
    each keeps its `Shard` as `.shard`.  Returns the names."""
    names = param_sharding(model, mesh)
    params = dict(model.named_parameters())
    for name, ax in names.items():
        p = params[name]
        shard = Shard(mesh.model_group, mesh.model, mesh.model_index, ax)
        p.data = _take(p.data, shard)
        if p.grad is not None:
            p.grad = torch.zeros_like(p)
        p.shard = shard
    return sorted(names)


def _gather_full(t, shard):
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.contiguous(), group=shard.group)
    return torch.cat(parts, dim=shard.axis)


@contextlib.contextmanager
def gathered(state):
    """Inside the block every sharded parameter of `state` (a
    `train.state.TrainState`) and its Adam moments are the full arrays,
    gathered over the model group (every rank enters it); on leaving, each
    rank takes its slice of them again, so a restore inside the block
    lands in the shards."""
    sharded = [p for p in state.parameters()
               if getattr(p, "shard", None) is not None]
    moments = ("exp_avg", "exp_avg_sq")
    for p in sharded:
        p.data = _gather_full(p.data, p.shard)
        st = state.optimizer.state.get(p, {})
        for k in moments:
            if k in st:
                st[k] = _gather_full(st[k], p.shard)
    try:
        yield state
    finally:
        for p in sharded:
            p.data = _take(p.data, p.shard)
            st = state.optimizer.state.get(p, {})
            for k in moments:
                if k in st:
                    st[k] = _take(st[k], p.shard)


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------

def replicate(model):
    """Every rank takes rank 0's parameters and buffers."""
    if dist.is_initialized():
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, src=0)
    return model


def _batch_norms(model):
    from relativepose_tpu_torch.models.blocks import BatchNorm2d
    return [m for m in model.modules()
            if isinstance(m, BatchNorm2d) and not m.frozen]


def shard_train_state(state, mesh: Mesh, tensor_parallel: bool = True):
    """Place a `TrainState` on the mesh, in place: every network takes
    rank 0's weights, batch statistics reduce over the data group, the
    trained networks' large kernels are split over the model group (with
    `tensor_parallel`), and each trained network is wrapped in DDP over
    the data group (`state.module(name)`).  Returns the state."""
    state.mesh = mesh
    if not dist.is_initialized():
        return state
    for model in (*state.models.values(), *state.frozen.values()):
        replicate(model)
        for bn in _batch_norms(model):
            bn.sync_group = mesh.data_group
    if tensor_parallel and mesh.model > 1:
        for model in state.models.values():
            shard_module(model, mesh)
        for p in state.parameters():
            st = state.optimizer.state.get(p, {})
            if getattr(p, "shard", None) is not None:
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in st and st[k].shape != p.shape:
                        st[k] = _take(st[k], p.shard)
    from torch.nn.parallel import DistributedDataParallel as DDP
    for name, model in state.models.items():
        dev = next(model.parameters()).device
        state.wrapped[name] = DDP(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            process_group=mesh.data_group, find_unused_parameters=True)
    return state


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def sharded_pose_estimator(scnet_fn, cfg, mesh: Mesh, device="cuda"):
    """fn(data_s, data_t, hp_table, seeds) -> poses [B, 4, 4] of the
    global pair batch: each rank of the data group runs its rows through
    `pipeline.recurrent.estimate_pose_via_completion`, pair i drawing its
    keypoints from a generator seeded with seeds[i] (so the poses do not
    depend on the split), and the poses are all-gathered.  A batch that
    does not divide by the data size is padded with copies of its last
    pair, and the copies' poses are dropped."""
    from relativepose_tpu_torch.pipeline.recurrent import (
        as_pair_batch,
        estimate_pose_via_completion,
    )

    def fn(data_s, data_t, hp_table, seeds):
        ds, dt = as_pair_batch(data_s, device), as_pair_batch(data_t, device)
        seeds = torch.as_tensor(np.asarray(seeds, np.int64))
        b = int(seeds.shape[0])
        p = (-b) % mesh.data

        def edge(x):
            if getattr(x, "ndim", 0) == 0 or p == 0:
                return x
            return torch.cat([x, x[-1:].expand((p,) + tuple(x.shape[1:]))])

        ds, dt, seeds = shard_batch(tree_map(edge, (ds, dt, seeds)), mesh)
        gens = [torch.Generator(device=device).manual_seed(int(s))
                for s in seeds]
        with torch.no_grad():
            T = estimate_pose_via_completion(scnet_fn, ds, dt, hp_table, cfg,
                                             generator=gens, device=device)
        if mesh.data > 1:
            parts = [torch.empty_like(T) for _ in range(mesh.data)]
            dist.all_gather(parts, T.contiguous(), group=mesh.data_group)
            T = torch.cat(parts)
        return T[:b]

    return fn


def spawn(fn, world: int, args=()):
    """Run fn(rank, *args) in `world` new processes and wait for them."""
    import torch.multiprocessing as mp
    mp.spawn(fn, args=args, nprocs=world, join=True)
