"""Conv blocks of the completion network.

Port of `relativepose_tpu/models/blocks.py`: Conv (or ConvTranspose) +
BatchNorm with batch statistics only + LeakyReLU(0.1).  Inside the network
activations are NCHW; `resize_bilinear` keeps the JAX package's NHWC at
its public signature.

BatchNorm statistics are taken per group of `group` consecutive samples
(the 2 views of one pano pair in the pipeline), which is what `vmap` over
pairs gives the JAX package.  Statistics are computed in f32 as
E[x^2] - E[x]^2 and the result is cast back to the activation dtype.  In
data-parallel training (`train/mesh.py`) each group's sums are reduced
over the data group, so the statistics are the global batch's.  A conv
whose kernel is split over a model group gathers its output channels
(`mesh.gather_channels`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from relativepose_tpu_torch.train import mesh


class BatchNorm2d(nn.Module):
    """Batch normalization with per-group batch statistics, no running
    stats (torch BatchNorm2d(track_running_stats=False) per group).

    `weight` is the multiplier itself; the Flax/npz parameter `scale`
    stores weight - 1.  With `frozen`, running statistics folded into the
    affine: y = x * weight + bias in f32 (the JAX package's `frozen` mode).
    """

    def __init__(self, channels: int, eps: float = 1e-5,
                 frozen: bool = False):
        super().__init__()
        self.eps = eps
        self.frozen = frozen
        self.weight = nn.Parameter(1.0 + 0.02 * torch.randn(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        # the data group of `train/mesh.py`, whose ranks hold the other
        # rows of each group
        self.sync_group = None

    def forward(self, x, group=None):
        n, c, h, w = x.shape
        if self.frozen:
            y = x.float() * self.weight.view(1, c, 1, 1) \
                + self.bias.view(1, c, 1, 1)
            return y.to(x.dtype)
        g = group or n
        if self.sync_group is None:
            xf = x.float().reshape(n // g, g, c, h, w)
            mean = xf.mean(dim=(1, 3, 4), keepdim=True)
            var = (xf * xf).mean(dim=(1, 3, 4), keepdim=True) - mean * mean
        else:
            # f64 activations keep f64 statistics here, so that an f64 step
            # on several ranks can be held to the 1-rank step: in f32 the
            # order of the sums moves SCNet's 1x1 bottleneck visibly
            # (tests/test_torch_mesh.py)
            xf = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(
                n // g, g, c, h, w)
            sums = mesh.global_sum(torch.cat([
                xf.sum(dim=(1, 3, 4), keepdim=True),
                (xf * xf).sum(dim=(1, 3, 4), keepdim=True)], dim=1),
                self.sync_group)
            count = g * h * w * mesh.group_size(self.sync_group)
            mean, sq = sums[:, :1] / count, sums[:, 1:] / count
            var = sq - mean * mean
        y = (xf - mean) * torch.rsqrt(var + self.eps) \
            * self.weight.view(1, 1, c, 1, 1) + self.bias.view(1, 1, c, 1, 1)
        return y.reshape(n, c, h, w).to(x.dtype)


def _pair(k):
    return tuple(k) if isinstance(k, (tuple, list)) else (k, k)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           transpose=False):
    """F.conv2d (or F.conv_transpose2d) in x's dtype; a kernel split over
    a model group computes its output channels and gathers the rest."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    split = getattr(weight, "shard", None) is not None
    if split:
        x = mesh.split_conv_input(x, weight)
    if transpose:
        y = F.conv_transpose2d(x, w, None if split else b, stride, padding)
    else:
        y = F.conv2d(x, w, None if split else b, stride, padding, dilation)
    if not split:
        return y
    y = mesh.gather_channels(y, weight)
    return y if b is None else y + b.view(1, -1, 1, 1)


class ConvBlock(nn.Module):
    """Conv + [BN] + LeakyReLU(0.1), the original `conv2d`."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0,
                 dilation=1, batchnorm=True, act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, _pair(kernel_size), stride, padding,
                              dilation, bias=not batchnorm)
        nn.init.xavier_normal_(self.conv.weight)
        self.bn = BatchNorm2d(cout) if batchnorm else None
        self.act = act

    def forward(self, x, group=None):
        c = self.conv
        x = conv2d(x, c.weight, c.bias, c.stride, c.padding, c.dilation)
        if self.bn is not None:
            x = self.bn(x, group)
        return F.leaky_relu(x, 0.1) if self.act else x


class DeconvBlock(nn.Module):
    """ConvTranspose + [BN] + LeakyReLU(0.1), the original `deconv2d`.

    `weight` is torch's ConvTranspose2d layout [in, out, kh, kw]; the JAX
    package's HWIO kernel of the equivalent input-dilated convolution is
    this weight flipped in kh and kw (`models/convert.py`)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0,
                 batchnorm=True, act=True):
        super().__init__()
        kh, kw = _pair(kernel_size)
        if min(kh - 1 - padding, kw - 1 - padding) < 0:
            raise ValueError("unsupported ConvTranspose geometry")
        self.weight = nn.Parameter(torch.empty(cin, cout, kh, kw))
        nn.init.xavier_normal_(self.weight)
        self.bias = None if batchnorm else nn.Parameter(torch.zeros(cout))
        self.stride, self.padding = stride, padding
        self.bn = BatchNorm2d(cout) if batchnorm else None
        self.act = act

    def forward(self, x, group=None):
        x = conv2d(x, self.weight, self.bias, self.stride, self.padding,
                   transpose=True)
        if self.bn is not None:
            x = self.bn(x, group)
        return F.leaky_relu(x, 0.1) if self.act else x


def _resize_matrix(n_in: int, n_out: int):
    """Dense bilinear interpolation matrix [n_out, n_in], half-pixel
    centres, no antialias, edge-clamped (the JAX package's matrix)."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    w[rows, np.clip(i0, 0, n_in - 1)] += 1.0 - frac
    w[rows, np.clip(i0 + 1, 0, n_in - 1)] += frac
    return w


@functools.lru_cache(maxsize=None)
def _resize_matrices(h_in, w_in, h_out, w_out):
    return _resize_matrix(h_in, h_out), _resize_matrix(w_in, w_out)


def resize_nchw(x, size):
    """Bilinear resize of [N, C, H, W] to size=(H', W') with half-pixel
    centres and no antialias, as two products with the interpolation
    matrices (the same contraction as the JAX package)."""
    h_in, w_in = x.shape[-2:]
    if (h_in, w_in) == tuple(size):
        return x
    ah, aw = _resize_matrices(h_in, w_in, size[0], size[1])
    ah = torch.from_numpy(ah).to(device=x.device, dtype=x.dtype)
    aw = torch.from_numpy(aw).to(device=x.device, dtype=x.dtype)
    return (ah @ x) @ aw.T


def resize_bilinear(x, size):
    """NHWC [..., H, W, C] bilinear resize (port of the JAX function)."""
    y = resize_nchw(x.movedim(-1, -3), size)
    return y.movedim(-3, -1)
