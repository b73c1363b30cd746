"""Flax parameter trees <-> the port's `state_dict`s, in memory.

`load_flax_params` takes a Flax parameter tree (nested dicts of arrays)
or a flat dict of numpy arrays with '/'-joined keys, as the shipped
`relativepose_tpu/data/pretrained/*.npz` files hold them, and loads it
into the port's SCNet, Resnet18_8s or SegmentationHead
(`scnet_state_dict` gives SCNet's `state_dict`).  `flax_params` goes the
other way: a port module (or gradients or Adam moments of its
parameters) -> the Flax-keyed tree of numpy arrays, which the checkpoints
of `utils/checkpoint.py` hold.  Nothing converted is written by this
module.

Name map, one rule per block kind (torch prefix <-> Flax prefix, `{}`
the block index):
  * SCNet: `convs.{}` <-> `ConvBlock_{}`, `deconvs.{}` <-> `DeconvBlock_{}`,
    `heads.{}` <-> `Conv_{}`;
  * Resnet18_8s: `conv1`/`bn1` <-> `Conv_0`/`BatchNorm2d_0`,
    `blocks.{}` <-> `BasicBlock_{}` (conv1, bn1, conv2, bn2, down_conv,
    down_bn <-> Conv_0, BatchNorm2d_0, Conv_1, BatchNorm2d_1, Conv_2,
    BatchNorm2d_2), `score8/16/32` <-> `Conv_1/2/3`;
  * SegmentationHead: `conv` <-> `Conv_0`.
Layouts:
  * conv kernels HWIO <-> OIHW;
  * the deconv kernel is HWIO of an input-dilated convolution: transposed
    to [I, O, kh, kw] and flipped in kh and kw it is the ConvTranspose2d
    weight;
  * BatchNorm `scale` stores weight - 1.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# (torch prefix, Flax prefix, kind); kind is conv, deconv or bn
_SCNET = (
    ("convs.{}.conv", "ConvBlock_{}/Conv_0", "conv"),
    ("convs.{}.bn", "ConvBlock_{}/BatchNorm2d_0", "bn"),
    ("deconvs.{}.bn", "DeconvBlock_{}/BatchNorm2d_0", "bn"),
    ("deconvs.{}", "DeconvBlock_{}", "deconv"),
    ("heads.{}", "Conv_{}", "conv"),
)
_RESNET = (
    ("conv1", "Conv_0", "conv"),
    ("bn1", "BatchNorm2d_0", "bn"),
    ("blocks.{}.conv1", "BasicBlock_{}/Conv_0", "conv"),
    ("blocks.{}.bn1", "BasicBlock_{}/BatchNorm2d_0", "bn"),
    ("blocks.{}.conv2", "BasicBlock_{}/Conv_1", "conv"),
    ("blocks.{}.bn2", "BasicBlock_{}/BatchNorm2d_1", "bn"),
    ("blocks.{}.down_conv", "BasicBlock_{}/Conv_2", "conv"),
    ("blocks.{}.down_bn", "BasicBlock_{}/BatchNorm2d_2", "bn"),
    ("score8", "Conv_1", "conv"),
    ("score16", "Conv_2", "conv"),
    ("score32", "Conv_3", "conv"),
)
_SEG = (("conv", "Conv_0", "conv"),)
# leaf names: torch <-> Flax
_LEAVES = {"conv": {"weight": "kernel", "bias": "bias"},
           "deconv": {"weight": "kernel", "bias": "bias"},
           "bn": {"weight": "scale", "bias": "bias"}}


def flatten_params(params, prefix=""):
    """Nested dict -> {'a/b/c': array}; a flat dict passes through.  A
    leading 'params/' level is dropped."""
    flat = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            flat.update(flatten_params(dict(v.items()), key))
        else:
            flat[key] = np.asarray(v)
    return {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in flat.items()}


def _pattern(template, sep):
    return re.compile(re.escape(template).replace(r"\{\}", r"(\d+)")
                      + re.escape(sep) + r"(\w+)$")


def _rename(key, rules, src, dst, sep_src, sep_dst):
    """Map one parameter name across by the first rule that matches it;
    returns (new name, kind, source leaf name)."""
    for rule in rules:
        m = _pattern(rule[src], sep_src).fullmatch(key)
        if m is None:
            continue
        idx, leaf = m.groups()[:-1], m.group(m.lastindex)
        names = _LEAVES[rule[2]] if src == 0 else \
            {v: k for k, v in _LEAVES[rule[2]].items()}
        if leaf not in names:
            break
        return (rule[dst].format(*idx) + sep_dst + names[leaf], rule[2],
                leaf)
    raise KeyError(f"unexpected parameter {key!r}")


def _to_torch(params, rules, offset: bool = True):
    sd = {}
    for key, arr in flatten_params(params).items():
        name, kind, leaf = _rename(key, rules, 1, 0, "/", ".")
        arr = np.asarray(arr, dtype=np.float32)
        if leaf == "kernel":
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1) if kind == "deconv" \
                else arr.transpose(3, 2, 0, 1)
        elif leaf == "scale" and offset:
            arr = arr + 1.0
        sd[name] = torch.from_numpy(np.array(arr, order="C"))
    return sd


def scnet_state_dict(params):
    """Flax SCNet params -> {torch name: f32 tensor}."""
    return _to_torch(params, _SCNET)


def load_flax_params(model, params):
    """Load Flax params into the port's SCNet, Resnet18_8s or
    SegmentationHead `model` (strict); returns the model."""
    model.load_state_dict(_to_torch(params, _rules(model)), strict=True)
    return model


def torch_arrays(model, params, moments: bool = False):
    """A Flax tree of `model`'s parameters -> {torch name: f32 tensor}, by
    the rules and layouts above; with `moments`, a tree of Adam moments of
    them (BatchNorm scales carry no offset there)."""
    return _to_torch(params, _rules(model), offset=not moments)


def _rules(model):
    from relativepose_tpu_torch.models.resnet import (
        Resnet18_8s,
        SegmentationHead,
    )
    if isinstance(model, Resnet18_8s):
        return _RESNET
    if isinstance(model, SegmentationHead):
        return _SEG
    return _SCNET


def flax_params(model, grads: bool = False, moments: dict = None):
    """The port's SCNet, Resnet18_8s or SegmentationHead -> the Flax
    parameter tree (nested dicts of f32 numpy arrays); with `grads`, the
    tree of the parameters' gradients; with `moments` ({torch name:
    tensor}, e.g. an Adam moment of each parameter), the tree of those
    (BatchNorm scales carry no offset in either)."""
    rules = _rules(model)
    tree = {}
    offset = not grads and moments is None
    if moments is not None:
        values = moments
    elif grads:
        values = {k: p.grad for k, p in model.named_parameters()}
    else:
        values = model.state_dict()
    for key, t in values.items():
        name, kind, leaf = _rename(key, rules, 0, 1, ".", "/")
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight" and kind == "deconv":
            arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif leaf == "weight" and kind == "conv":
            arr = arr.transpose(2, 3, 1, 0)
        elif kind == "bn" and leaf == "weight" and offset:
            arr = arr - 1.0
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree
