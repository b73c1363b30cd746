"""An orbax PyTree checkpoint directory -> a nested tree of numpy arrays,
as `orbax.checkpoint.PyTreeCheckpointer().restore(path)` returns it, read
without JAX, orbax, tensorstore or a zstd package.

What orbax 0.11 writes (`PyTreeCheckpointHandler`, the JAX package's
`utils/checkpoint.py::CheckpointManager`):
- `_METADATA`, JSON: `tree_metadata` maps each leaf to its key path
  (`key_metadata`: the key and its `key_type`, 1 a sequence index, 2 a dict
  key) and its `value_metadata` (`value_type`: `np.ndarray`, `jax.Array`
  or `scalar` for an array; `None`, `Dict`, `List`, `Tuple` or `NamedTuple`
  for an empty node, with `skip_deserialize`), plus the flags `use_ocdbt`
  and `use_zarr3`.
- The arrays, in zarr v2 inside the checkpoint's OCDBT database
  (`utils/ocdbt.py`): a leaf named by its key path joined with '.' has its
  metadata at `<name>/.zarray` and its chunks at `<name>/<i>.<j>...`
  (`<name>/0` for a 0-d array), each one zstd frame (`native/zstd.py`).

Sequences come back as lists, empty named tuples (optax's `EmptyState`)
as None, `scalar` leaves as Python numbers, as orbax restores them.
bfloat16 leaves come back as `torch.bfloat16` tensors, since numpy has
no bfloat16 without `ml_dtypes`.  zarr3 checkpoints, checkpoints without
OCDBT, string leaves and compressors other than zstd raise
NotImplementedError with their name.
"""

from __future__ import annotations

import itertools
import json
import math
import os

import numpy as np

from relativepose_tpu_torch.native import zstd
from relativepose_tpu_torch.utils.ocdbt import OcdbtReader

ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")
EMPTY_VALUES = {"None": lambda: None, "NamedTuple": lambda: None,
                "Dict": dict, "List": list, "Tuple": tuple}
SEQUENCE_KEY, DICT_KEY = 1, 2
_NUMERIC_KINDS = "biuf"


def is_checkpoint(path: str) -> bool:
    """Whether `path` is a directory that orbax finished writing."""
    return os.path.isfile(os.path.join(path, "_METADATA"))


def _dtype(name: str):
    """The numpy dtype of a zarr v2 dtype string ('bfloat16' -> uint16, the
    bits)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    if dt is None or dt.kind not in _NUMERIC_KINDS or dt.byteorder == ">":
        raise NotImplementedError(f"zarr dtype {name!r} is not read")
    return dt


def _fill(meta: dict, dt):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):   # zarr v2 spells non-finite floats so
        value = {"NaN": np.nan, "Infinity": np.inf,
                 "-Infinity": -np.inf}[value]
    if meta["dtype"] == "bfloat16":
        return int(np.float32(value).view(np.uint32) >> 16)
    return value


def read_array(kv: OcdbtReader, name: str):
    """The zarr v2 array `name` of an OCDBT store, any chunk grid: edge
    chunks are cut to the shape, missing chunks filled with the array's
    fill value."""
    meta = json.loads(kv.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(
            f"{name}: zarr_format {meta.get('zarr_format')}")
    comp = (meta.get("compressor") or {}).get("id")
    if comp != "zstd":
        raise NotImplementedError(f"{name}: zarr compressor {comp!r} (only "
                                  "zstd, which orbax writes, is read)")
    if meta.get("filters"):
        raise NotImplementedError(f"{name}: zarr filters {meta['filters']}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise ValueError(f"{name}: zarr order {order!r}")
    dt = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = math.prod(chunks) * dt.itemsize
    grid = itertools.product(*(range(-(-s // c))
                               for s, c in zip(shape, chunks)))
    keys = [(idx, f"{name}/{sep.join(map(str, idx)) if idx else '0'}")
            for idx in grid]
    # one whole C-order chunk (what orbax writes) is decoded in place
    single = chunks == shape and order == "C" and keys[0][1] in kv
    out = np.empty(shape, dt) if single else \
        np.full(shape, _fill(meta, dt), dt)
    for idx, key in keys:
        if key not in kv:
            continue
        buf = out if single else np.empty(chunk_bytes, np.uint8)
        if zstd.decompress_into(kv.read(key), buf) != chunk_bytes:
            raise ValueError(f"{key}: decoded size differs from "
                             f"{chunk_bytes} bytes")
        if not single:
            chunk = buf.view(dt).reshape(chunks, order=order)
            lo = [i * c for i, c in zip(idx, chunks)]
            hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
            out[tuple(map(slice, lo, hi))] = \
                chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    if meta["dtype"] == "bfloat16":
        import torch
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _build(node):
    """Lists from the {index: value} dicts that sequence levels built."""
    if isinstance(node, _Seq):
        return [_build(node[i]) for i in sorted(node)]
    if isinstance(node, dict):
        return {k: _build(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A sequence level while the tree is built, keyed by index."""


def restore(path: str):
    """The tree in orbax checkpoint directory `path` (e.g.
    `<params>/checkpoint_0003`)."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{path}: no orbax _METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{path}: use_zarr3 checkpoints (zarr v3) "
                                  "are not read")
    if not meta.get("use_ocdbt", False):
        raise NotImplementedError(f"{path}: checkpoints without use_ocdbt "
                                  "are not read")
    kv = None
    root = None
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in ARRAY_TYPES:
            kv = kv or OcdbtReader(path)
            value = read_array(kv, ".".join(k["key"] for k in keys))
            if value_type == "scalar":
                value = value.item()
        elif value_type in EMPTY_VALUES:
            value = EMPTY_VALUES[value_type]()
        else:
            raise NotImplementedError(
                f"{path}: orbax value type {value_type!r} is not read")
        if any(k["key_type"] not in (SEQUENCE_KEY, DICT_KEY) for k in keys):
            raise ValueError(f"{path}: key types {keys}")
        if root is None:
            root = _Seq() if keys[0]["key_type"] == SEQUENCE_KEY else {}
        node = root
        for k, nxt in zip(keys, keys[1:] + [None]):
            key = int(k["key"]) if k["key_type"] == SEQUENCE_KEY else k["key"]
            if nxt is None:
                node[key] = value
            else:
                if key not in node:
                    node[key] = _Seq() if nxt["key_type"] == SEQUENCE_KEY \
                        else {}
                node = node[key]
    return _build(root)
