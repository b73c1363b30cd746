"""A nested tree of arrays -> an orbax PyTree checkpoint directory, as the
JAX package's `utils/checkpoint.py::CheckpointManager.save` writes it
with orbax 0.11, written without JAX, orbax, tensorstore or a zstd
package.  The inverse of `utils/orbax_read.py`, whose docstring gives the
layout.

What `save` writes into a checkpoint directory:
- `_METADATA`: each leaf's key path (`key_type` 2 for a dict key or a
  named tuple's field, 1 for a sequence index), `value_type` 'np.ndarray'
  (the JAX manager turns every leaf into a numpy array first); an empty
  node with `skip_deserialize` and `value_type` 'None' (None, and an empty
  named tuple such as optax's `EmptyState`), 'Dict', 'List' or 'Tuple';
  `use_ocdbt` true, `use_zarr3` false;
- `_CHECKPOINT_METADATA`: the handler's name and the timestamps;
- one OCDBT database (`utils/ocdbt.py::write_ocdbt`) at the checkpoint's
  root, holding each array as zarr v2: `<name>/.zarray` and one
  whole-array chunk `<name>/0.0...` (`<name>/0` for a 0-d array), a zstd
  frame of raw blocks (`native/zstd.py::frame_raw`) under the `.zarray`'s
  `{"id": "zstd", "level": 1}`, as orbax labels its chunks.
Orbax merges its processes' databases under `ocdbt.process_<i>/`; one
database at the root is what such a merge reads as, and what orbax and
tensorstore open.

Leaves are numpy arrays, numpy or Python scalars, or torch tensors; their
dtypes are those `orbax_read` reads back (bool, integers, floats and
bfloat16, little-endian); any other raises NotImplementedError with its
name, and an array of zero size raises ValueError, as orbax's save
does.  The directory is written under a temporary name beside its own
and renamed into place, so an interrupted save leaves no
`checkpoint_%04d/` without `_METADATA` for either package's manager.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from relativepose_tpu_torch.native import zstd
from relativepose_tpu_torch.utils.ocdbt import write_ocdbt
from relativepose_tpu_torch.utils.orbax_read import DICT_KEY, SEQUENCE_KEY

HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
           "PyTreeCheckpointHandler")
_NUMERIC_KINDS = "biuf"


def _array(value):
    """(a C-contiguous numpy array, its zarr v2 dtype) of a leaf."""
    if type(value).__module__.startswith("torch"):
        import torch
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        value = t.numpy()
    a = np.asarray(value)
    if not a.flags.c_contiguous:   # (np.ascontiguousarray makes 0-d 1-d)
        a = a.copy(order="C")
    if a.dtype.name == "bfloat16":              # ml_dtypes
        return a.view(np.uint16), "bfloat16"
    if a.dtype.kind not in _NUMERIC_KINDS or a.dtype.byteorder == ">":
        raise NotImplementedError(f"dtype {a.dtype.name!r} is not written")
    return a, a.dtype.str


def flatten(tree) -> list:
    """[(key path [(key, key_type)], leaf or the value_type of an empty
    node)] of `tree`, dict keys sorted as JAX flattens them."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            items = [(str(k), DICT_KEY, node[k]) for k in sorted(node)]
            empty = "Dict"
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            items = [(f, DICT_KEY, getattr(node, f)) for f in node._fields]
            empty = "None"
        elif isinstance(node, (list, tuple)):
            items = [(str(i), SEQUENCE_KEY, v) for i, v in enumerate(node)]
            empty = "List" if isinstance(node, list) else "Tuple"
        elif node is None:
            items, empty = [], "None"
        else:
            out.append((path, node))
            return
        if not items:
            out.append((path, empty))
        for key, kind, v in items:
            walk(v, path + [(key, kind)])

    walk(tree, [])
    return out


def _zarray(a: np.ndarray, dtype: str) -> bytes:
    return json.dumps({
        "chunks": list(a.shape), "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": dtype, "fill_value": None,
        "filters": None, "order": "C", "shape": list(a.shape),
        "zarr_format": 2}, separators=(",", ":"), sort_keys=True).encode()


def save(path: str, tree: dict,
         max_decoded_node_bytes: int = None) -> str:
    """Write `tree` (a dict) as the orbax checkpoint directory `path`,
    replacing one that is there; returns `path`.  `max_decoded_node_bytes`
    overrides orbax's 100 MB OCDBT nodes (tests)."""
    if not isinstance(tree, dict) or not tree:
        raise ValueError("an orbax checkpoint holds a non-empty dict")
    path = os.path.abspath(path)
    init_ns = time.time_ns()
    meta, values = {}, {}
    for keys, leaf in flatten(tree):
        key_meta = [{"key": k, "key_type": t} for k, t in keys]
        if isinstance(leaf, str):
            value_meta = {"value_type": leaf, "skip_deserialize": True}
        else:
            a, dtype = _array(leaf)
            name = ".".join(k for k, _ in keys)
            if not a.size:   # orbax refuses them too
                raise ValueError(f"{name}: an array of zero size")
            values[f"{name}/.zarray"] = _zarray(a, dtype)
            values[f"{name}/{'.'.join('0' * a.ndim) or '0'}"] = \
                zstd.frame_raw(a.reshape(-1).view(np.uint8))
            value_meta = {"value_type": "np.ndarray",
                          "skip_deserialize": False}
        meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": key_meta, "value_metadata": value_meta}
    parent, base = os.path.split(path)
    tmp = os.path.join(parent, f".{base}.tmp-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        kw = {} if max_decoded_node_bytes is None else \
            {"max_decoded_node_bytes": max_decoded_node_bytes}
        write_ocdbt(tmp, values, **kw)
        del values
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": meta, "use_ocdbt": True,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": init_ns,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path
