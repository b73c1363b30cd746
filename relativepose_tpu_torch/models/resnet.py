"""Resnet18_8s feature network (an FCN-8s head over a ResNet-18 trunk).

Port of `relativepose_tpu/models/resnet.py`: a ResNet-18 whose first conv
takes `num_input` channels (7 = rgb + normal + depth), 1x1 score convs to
`feature_dim` channels at strides 8, 16 and 32, top-down additive fusion
through bilinear upsampling (the JAX package's interpolation matrices,
`blocks.resize_nchw`), a final upsample to the input size and an optional
tanh.  BatchNorm takes its statistics over the whole batch it is given,
or folds running statistics into an affine with `frozen_bn`.

Layout: NHWC at `forward`, NCHW inside.  With `dtype` (bf16 on the card)
activations and conv weights are cast to it while the parameters stay f32,
as Flax's `dtype=` does.  Module names follow the Flax tree
(`models/convert.py`): `conv1`/`bn1` the stem, `blocks[i]` BasicBlock_i,
`score8`/`score16`/`score32` the score convs.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from relativepose_tpu_torch.models.blocks import (
    BatchNorm2d,
    conv2d,
    resize_nchw,
)


def _lecun_normal_(w):
    """Flax's default conv initialiser: truncated normal, variance
    1 / fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def _conv(x, conv):
    return conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)


def _xavier_conv(cin, cout, k, stride=1, padding=0):
    c = nn.Conv2d(cin, cout, k, stride, padding, bias=False)
    nn.init.xavier_normal_(c.weight)
    return c


def _score_conv(cin, cout):
    c = nn.Conv2d(cin, cout, 1)
    _lecun_normal_(c.weight)
    nn.init.zeros_(c.bias)
    return c


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 frozen_bn: bool = False):
        super().__init__()
        self.conv1 = _xavier_conv(cin, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes, frozen=frozen_bn)
        self.conv2 = _xavier_conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes, frozen=frozen_bn)
        if stride != 1 or cin != planes:
            self.down_conv = _xavier_conv(cin, planes, 1, stride, 0)
            self.down_bn = BatchNorm2d(planes, frozen=frozen_bn)
        else:
            self.down_conv = None

    def forward(self, x):
        y = F.relu(self.bn1(_conv(x, self.conv1)))
        y = self.bn2(_conv(y, self.conv2))
        res = x if self.down_conv is None else \
            self.down_bn(_conv(x, self.down_conv))
        return F.relu(y + res)


class Resnet18_8s(nn.Module):
    def __init__(self, num_input: int = 7, feature_dim: int = 32,
                 use_tanh: bool = True, stage_sizes=(2, 2, 2, 2),
                 base_width: int = 64, dtype=None, frozen_bn: bool = False):
        super().__init__()
        self.use_tanh = use_tanh
        self.dtype = dtype
        w0 = base_width
        self.conv1 = _xavier_conv(num_input, w0, 7, 2, 3)
        self.bn1 = BatchNorm2d(w0, frozen=frozen_bn)
        planes = (w0, 2 * w0, 4 * w0, 8 * w0)
        blocks, self.stage_ends = [], []
        cin = w0
        for stage, (p, n) in enumerate(zip(planes, stage_sizes)):
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(BasicBlock(cin, p, stride, frozen_bn))
                cin = p
            self.stage_ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)
        self.score8 = _score_conv(planes[1], feature_dim)
        self.score16 = _score_conv(planes[2], feature_dim)
        self.score32 = _score_conv(planes[3], feature_dim)

    def forward(self, x):
        """x: [N, H, W, num_input] -> [N, H, W, feature_dim]."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        in_hw = tuple(x.shape[1:3])
        # contiguous NCHW: the CPU backward of a strided 1x1 conv on a
        # channels-last tensor (what the permute gives) corrupts memory in
        # the torch versions this was written against
        y = x.permute(0, 3, 1, 2).contiguous()
        y = F.relu(self.bn1(_conv(y, self.conv1)))
        y = F.max_pool2d(y, 3, 2, 1)
        feats = []
        for i, block in enumerate(self.blocks):
            y = block(y)
            if i + 1 in self.stage_ends[1:]:
                feats.append(y)
        s8 = _conv(feats[0], self.score8)
        s16 = _conv(feats[1], self.score16)
        s32 = _conv(feats[2], self.score32)
        logits16 = s16 + resize_nchw(s32, s16.shape[-2:])
        logits8 = s8 + resize_nchw(logits16, s8.shape[-2:])
        out = resize_nchw(logits8, in_hw)
        if self.use_tanh:
            out = torch.tanh(out)
        return out.permute(0, 2, 3, 1)


class SegmentationHead(nn.Module):
    """1x1 conv feature map -> class logits, NHWC."""

    def __init__(self, feature_dim: int, num_classes: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv = _score_conv(feature_dim, num_classes)

    def forward(self, feat):
        if self.dtype is not None:
            feat = feat.to(self.dtype)
        y = _conv(feat.permute(0, 3, 1, 2).contiguous(), self.conv)
        return y.permute(0, 2, 3, 1)
