"""The original repository's PyTorch checkpoints -> the port's networks.

Counterpart of `relativepose_tpu/utils/torch_import.py`.  The original
ships `state_dict` checkpoints (`<ds>.feat.pth.tar`, `<ds>.comp.pth.tar`)
whose module names follow its own Resnet18_8s, segmentation layer and
SCNet.  This module maps them onto the Flax-layout parameter tree of the
JAX package (numpy only), which `models/convert.py::load_flax_params`
loads into the port's modules:

  * Conv2d weight [O, I, kH, kW] -> [kH, kW, I, O];
  * ConvTranspose2d weight [I, O, kH, kW] -> spatially flipped
    [kH, kW, I, O] (the Flax deconv is an input-dilated convolution);
  * BatchNorm with track_running_stats=False (SCNet's, batch statistics
    at evaluation too) -> (weight - 1, bias): the tree's `scale` stores
    the multiplier minus one, and `load_flax_params` adds the one back;
  * BatchNorm with running statistics (the ResNet-18 trunk) -> the
    evaluation-mode affine, scale = w / sqrt(rv + eps) and bias =
    b - rm * scale, for `BatchNorm2d(frozen=True)`
    (`Resnet18_8s(frozen_bn=True)`).

`load_resnet18_8s`, `load_segmentation_head` and `load_scnet` build the
port's module and load a state dict into it; the `import_*` functions
give the tree, checked against an optional template tree's keys and
shapes.
"""

from __future__ import annotations

import numpy as np

BN_EPS = 1e-5  # torch BatchNorm2d's default


def convert_conv(w):
    """torch Conv2d [O, I, kH, kW] -> [kH, kW, I, O]."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def convert_deconv(w):
    """torch ConvTranspose2d [I, O, kH, kW] -> the input-dilated
    convolution's kernel [kH, kW, I, O], spatially flipped."""
    w = np.asarray(w)[:, :, ::-1, ::-1]
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def convert_bn(weight, bias):
    """BatchNorm(track_running_stats=False) (weight, bias) -> the tree's
    (scale, bias), scale = weight - 1."""
    return np.asarray(weight, np.float32) - 1.0, np.asarray(bias, np.float32)


def fold_bn_eval(weight, bias, running_mean, running_var, eps=BN_EPS):
    """Evaluation-mode BN (running statistics) folded into the frozen
    BN's (scale - 1, bias), in f64 before the cast."""
    w = np.asarray(weight, np.float64)
    b = np.asarray(bias, np.float64)
    rm = np.asarray(running_mean, np.float64)
    rv = np.asarray(running_var, np.float64)
    scale = w / np.sqrt(rv + eps)
    return ((scale - 1.0).astype(np.float32),
            (b - rm * scale).astype(np.float32))


def load_torch_state_dict(path):
    """A `.pth.tar` -> {name: numpy array}: the `state_dict` entry if the
    file has one, with DataParallel's `module.` prefixes removed."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)
    return out


def _bn_from(sd, prefix):
    """BN at `prefix`: folded when it has running statistics, else the
    track_running_stats=False kind."""
    if f"{prefix}.running_mean" in sd:
        scale, bias = fold_bn_eval(
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"],
            sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"])
    else:
        scale, bias = convert_bn(sd[f"{prefix}.weight"], sd[f"{prefix}.bias"])
    return {"scale": scale, "bias": bias}


def _plain_conv(sd, prefix):
    """A bare Conv2d with bias (score convs, the deconv1* heads)."""
    return {"kernel": convert_conv(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def check_template(params, template, path=""):
    """Raise unless `params` has the keys and leaf shapes of `template`."""
    if template is None:
        return
    pk, tk = set(params), set(template)
    if pk != tk:
        raise ValueError(
            f"torch_import: key mismatch at '{path}': produced "
            f"{sorted(pk - tk)} extra, missing {sorted(tk - pk)}")
    for k in pk:
        p, t = params[k], template[k]
        if isinstance(t, dict):
            check_template(p, t, f"{path}/{k}")
        elif tuple(np.shape(p)) != tuple(np.shape(t)):
            raise ValueError(
                f"torch_import: shape mismatch at '{path}/{k}': "
                f"{np.shape(p)} vs template {np.shape(t)}")


def import_resnet18_8s(sd, template=None):
    """The feature net: torch names `resnet18_32s.conv1/bn1/layer{1..4}.
    {0,1}.*` and `score_{8,16,32}s` -> Conv_0 / BatchNorm2d_0 (stem),
    BasicBlock_{0..7} (layer1.0 .. layer4.1), Conv_1..3 (score 8s, 16s,
    32s), for `Resnet18_8s(frozen_bn=True)`."""
    t = "resnet18_32s"
    p = {
        "Conv_0": {"kernel": convert_conv(sd[f"{t}.conv1.weight"])},
        "BatchNorm2d_0": _bn_from(sd, f"{t}.bn1"),
    }
    blk = 0
    for layer in range(1, 5):
        for b in range(2):
            tb = f"{t}.layer{layer}.{b}"
            sub = {
                "Conv_0": {"kernel": convert_conv(sd[f"{tb}.conv1.weight"])},
                "BatchNorm2d_0": _bn_from(sd, f"{tb}.bn1"),
                "Conv_1": {"kernel": convert_conv(sd[f"{tb}.conv2.weight"])},
                "BatchNorm2d_1": _bn_from(sd, f"{tb}.bn2"),
            }
            if f"{tb}.downsample.0.weight" in sd:
                sub["Conv_2"] = {
                    "kernel": convert_conv(sd[f"{tb}.downsample.0.weight"])}
                sub["BatchNorm2d_2"] = _bn_from(sd, f"{tb}.downsample.1")
            p[f"BasicBlock_{blk}"] = sub
            blk += 1
    p["Conv_1"] = _plain_conv(sd, "score_8s")
    p["Conv_2"] = _plain_conv(sd, "score_16s")
    p["Conv_3"] = _plain_conv(sd, "score_32s")
    check_template(p, template)
    return p


def import_segmentation_head(sd, template=None):
    """The original segmentation layer (`segm_layer`) -> Conv_0."""
    p = {"Conv_0": _plain_conv(sd, "segm_layer")}
    check_template(p, template)
    return p


def _head_active(output_type):
    """The per-modality heads, in the order both networks build them."""
    ot = output_type
    return [m for m, on in (
        ("rgb", "rgb" in ot),
        ("n", "n" in ot.replace("rgb", "")),
        ("d", "d" in ot),
        ("k", "k" in ot),
        ("s", "s" in ot),
        ("f", "f" in ot),
    ) if on]


def scnet_name_map(output_type):
    """torch module name -> (tree name, kind) for SCNet; kind is
    conv_block, deconv_block or plain_conv.  The tree numbers blocks in
    construction order: ConvBlock_0..8 the stems, ConvBlock_9..14 conv4..9,
    DeconvBlock_0..5 deconv9..4, then per active head (rgb, n, d, k, s, f)
    two DeconvBlocks and one Conv."""
    m = {}
    stems = ["conv1rgb", "conv2rgb", "conv3rgb",
             "conv1n", "conv2n", "conv3n",
             "conv1d", "conv2d", "conv3d"]
    for i, name in enumerate(stems):
        m[name] = (f"ConvBlock_{i}", "conv_block")
    for i, name in enumerate(["conv4", "conv5", "conv6",
                              "conv7", "conv8", "conv9"]):
        m[name] = (f"ConvBlock_{9 + i}", "conv_block")
    for i, name in enumerate(["deconv9", "deconv8", "deconv7",
                              "deconv6", "deconv5", "deconv4"]):
        m[name] = (f"DeconvBlock_{i}", "deconv_block")
    db, cv = 6, 0
    for mod in _head_active(output_type):
        m[f"deconv3{mod}"] = (f"DeconvBlock_{db}", "deconv_block")
        m[f"deconv2{mod}"] = (f"DeconvBlock_{db + 1}", "deconv_block")
        m[f"deconv1{mod}"] = (f"Conv_{cv}", "plain_conv")
        db, cv = db + 2, cv + 1
    return m


def import_scnet(sd, output_type="rgbdnsf", template=None, batchnorm=True):
    """The completion U-Net's state dict -> the SCNet tree.  Its BNs keep
    no running statistics, so nothing is folded."""
    p = {}
    for tname, (fname, kind) in scnet_name_map(output_type).items():
        if kind == "plain_conv":
            p[fname] = _plain_conv(sd, tname)
            continue
        # a Sequential block: .0 the conv, .1 the BN (with batchnorm)
        w = sd[f"{tname}.0.weight"]
        kernel = convert_deconv(w) if kind == "deconv_block" \
            else convert_conv(w)
        sub = {"kernel": kernel} if kind == "deconv_block" \
            else {"Conv_0": {"kernel": kernel}}
        if batchnorm:
            sub["BatchNorm2d_0"] = _bn_from(sd, f"{tname}.1")
        else:
            bias = np.asarray(sd[f"{tname}.0.bias"], np.float32)
            if kind == "deconv_block":
                sub["bias"] = bias
            else:
                sub["Conv_0"]["bias"] = bias
        p[fname] = sub
    check_template(p, template)
    return p


def _template(model):
    from relativepose_tpu_torch.models import convert
    return convert.flax_params(model)


def load_scnet(sd, net):
    """Load the original SCNet state dict `sd` into the port's SCNet
    `net` (its output type and batchnorm flag); returns `net`."""
    from relativepose_tpu_torch.models import convert
    params = import_scnet(sd, output_type=net.layout.output_type,
                          template=_template(net),
                          batchnorm=net.convs[0].bn is not None)
    return convert.load_flax_params(net, params)


def load_resnet18_8s(sd, net):
    """Load the original feature net's state dict into the port's
    Resnet18_8s `net`, which needs `frozen_bn=True` for the folded
    running statistics; returns `net`."""
    from relativepose_tpu_torch.models import convert
    if not net.bn1.frozen:
        raise ValueError("the original feature net's BatchNorm has running "
                         "statistics: build Resnet18_8s(frozen_bn=True)")
    return convert.load_flax_params(
        net, import_resnet18_8s(sd, template=_template(net)))


def load_segmentation_head(sd, head):
    from relativepose_tpu_torch.models import convert
    return convert.load_flax_params(
        head, import_segmentation_head(sd, template=_template(head)))
