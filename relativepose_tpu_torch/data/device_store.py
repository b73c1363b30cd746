"""Device-resident training set: upload once, sample batches on the card.

Port of `relativepose_tpu/data/device_store.py`.  The whole pair set lives
on the device in the original datasets' on-disk precision (rgb uint8,
normals int8, depth uint16 millimetres, segm uint8, poses f32), and every
training step gathers, decodes and augments its batch there
(`gather_batch` -> `pipeline.assemble_pair_batch`), with no per-step host
traffic.  One 160x640 pair is about 1.8 MB encoded.

Decoding multiplies by the f32 reciprocals of 255, 127 and 1000: that is
what the JAX package's compiled `gather_batch` computes for its divisions
by those constants, so the decoded batch is the same bit for bit on the
CPU, the card and the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from relativepose_tpu_torch import config
from relativepose_tpu_torch.data import pipeline as dpipe

_SCALES = {"rgb": 255.0, "norm": 127.0, "depth": 1000.0}


def encode_item(item: dict, with_full_frames: bool = True) -> dict:
    """One pair -> compact host arrays.  with_full_frames=False drops the
    scannet 480x640 kinect frames, which the training steps never read."""

    def both(f, enc):
        return np.stack([enc(np.asarray(item["data_s"][f])),
                         enc(np.asarray(item["data_t"][f]))])

    out = dict(rgb=both("rgb", encode_rgb), norm=both("norm", encode_norm),
               depth=both("depth", encode_depth),
               segm=both("segm", lambda a: a.astype(np.uint8)),
               pose=both("pose", lambda a: a.astype(np.float32)))
    if with_full_frames and "rgb_full" in item["data_s"]:
        out["rgb_full"] = both("rgb_full", encode_rgb)
    return out


def encode_rgb(a):
    return np.clip(np.asarray(a) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def encode_norm(a):
    return np.clip(np.round(np.asarray(a) * 127.0), -127, 127).astype(
        np.int8)


def encode_depth(a):
    """uint16 millimetres: exact to 1 mm up to 65.5 m."""
    return np.clip(np.round(np.asarray(a) * 1000.0), 0, 65535).astype(
        np.uint16)


def decode(x, name: str):
    """An encoded 'rgb' / 'norm' / 'depth' tensor -> f32 (depth as
    non-negative millimetres); a product with an f32 value rounds alike on
    every device."""
    return x.to(torch.float32) * float(np.float32(1.0)
                                       / np.float32(_SCALES[name]))


def as_tensor(a: np.ndarray, device):
    """An encoded numpy array -> a tensor on `device`; uint16 depth travels
    as its int16 bit pattern (`decode_batch` reads it back)."""
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def decode_batch(rgb, norm, depth, segm):
    """Encoded [B, 2, ...] tensors -> f32 rgb in [0, 1], normals, depth in
    metres, int64 segm.  depth is uint16 millimetres or their int16 bit
    pattern."""
    mm = depth.to(torch.int32) & 0xFFFF
    return (decode(rgb, "rgb"), decode(norm, "norm"), decode(mm, "depth"),
            segm.to(torch.int64))


class DeviceStore:
    """The whole pair set as device-resident compact tensors.

    source: any indexable of items with the PanoPairDataset contract
    (data_s / data_t dicts of rgb / norm / depth / segm / pose)."""

    def __init__(self, source, n: int | None = None, log=None,
                 device="cuda", with_full_frames: bool = True):
        n = len(source) if n is None else min(n, len(source))
        t0 = time.time()
        host = None
        for i in range(n):
            enc = encode_item(source[i], with_full_frames)
            if host is None:
                host = {k: [] for k in enc}
            for k, v in enc.items():
                host[k].append(v)
            if log and (i + 1) % 256 == 0:
                log(f"device_store: encoded {i + 1}/{n} pairs "
                    f"({time.time() - t0:.0f}s)")
        stacked = {k: np.stack(v) for k, v in host.items()}
        self.n = n
        self.nbytes = sum(a.nbytes for a in stacked.values())
        self.arrays = {k: as_tensor(v, device) for k, v in stacked.items()}
        if log:
            log(f"device_store: {n} pairs, {self.nbytes / 1e6:.0f} MB "
                f"resident ({time.time() - t0:.0f}s incl. upload)")


def gather_batch(arrays: dict, idx, dataset: str,
                 feature_learning: bool = True, draws=None, generator=None):
    """Gather the `idx` [B] pairs from the resident arrays, decode them and
    run the augmentation (`pipeline.assemble_pair_batch`), all on the
    arrays' device.  `draws` (a `pipeline.PairDraws`) defaults to fresh
    draws from `generator`."""
    with record_function("rp.augment"):
        rgb, norm, depth, segm = decode_batch(
            *(arrays[k][idx] for k in ("rgb", "norm", "depth", "segm")))
        if draws is None:
            draws = dpipe.draw_pair_batch(depth, dataset, generator)
        return dpipe.assemble_pair_batch(
            rgb, norm, depth, arrays["pose"][idx], segm, draws, dataset,
            feature_learning=feature_learning)


class ResidentLoader:
    """Iterable of device-assembled batches over a DeviceStore.

    Each pass is one shuffled epoch; a batch costs only launches (gather
    and augmentation run on the device)."""

    def __init__(self, store: DeviceStore, batch_size: int, dataset: str,
                 seed: int = 0, feature_learning: bool = True):
        self.store = store
        self.batch_size = batch_size
        self.dataset = config.canonical_dataset(dataset)
        self.feature_learning = feature_learning
        self._rng = np.random.RandomState(seed)
        self.device = store.arrays["rgb"].device

    def __iter__(self):
        order = self._rng.permutation(self.store.n)
        nb = self.store.n // self.batch_size
        gen = torch.Generator(device=self.device).manual_seed(
            int(self._rng.randint(2 ** 31)))
        for b in range(max(nb, 1)):
            lo = (b * self.batch_size) % max(
                self.store.n - self.batch_size + 1, 1)
            idx = torch.from_numpy(
                order[lo:lo + self.batch_size].astype(np.int64)).to(
                self.device)
            yield gather_batch(self.store.arrays, idx, self.dataset,
                               self.feature_learning, generator=gen)
