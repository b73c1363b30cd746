"""SCNet — the 2-view pano scene-completion U-Net.

Port of `relativepose_tpu/models/scnet.py`.  Input is a 16-channel pano
(a view's [rgb(3), normal(3), depth(1), mask(1)] and the warped
counterpart's 8 channels), resized to `internal_size` and back.  Three
modality stems (rgb / normal / depth) shared between the view and its
warped counterpart, a trunk down to ngf*16 x 1 x 1, a decoder with skip
concatenation, and per-modality heads rgb(3), n(3), d(1), k(1),
s(snumclass), f(feature_dim, tanh).  At internal_size (224, 224) the
bottleneck is the original 3/3/3 ladder; at other sizes one full-extent
conv and its transpose.

The blocks live in three lists in the order the Flax module creates them,
so that Flax's `ConvBlock_i`, `DeconvBlock_i` and `Conv_i` are
`convs[i]`, `deconvs[i]` and `heads[i]` (`models/convert.py`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from relativepose_tpu_torch.config import ChannelLayout
from relativepose_tpu_torch.models.blocks import (
    ConvBlock,
    DeconvBlock,
    conv2d,
    resize_nchw,
)


class SCNet(nn.Module):
    def __init__(self, output_type: str = "rgbdnsf", snumclass: int = 15,
                 feature_dim: int = 32, ngf: int = 64, batchnorm: bool = True,
                 skip_layer: bool = True, use_tanh: bool = True,
                 dtype=None, internal_size=(224, 224)):
        super().__init__()
        self.layout = ChannelLayout(output_type, snumclass, feature_dim)
        self.use_tanh = use_tanh
        self.dtype = dtype
        self.internal_size = tuple(internal_size)
        self.skip = skip_layer
        self.ladder = self.internal_size == (224, 224)
        sk = 1 if skip_layer else 0
        convs, deconvs, heads = [], [], []

        def conv(cin, cout, k, s, p):
            convs.append(ConvBlock(cin, cout, k, s, p, batchnorm=batchnorm))

        def deconv(cin, cout, k, s, p):
            deconvs.append(DeconvBlock(cin, cout, k, s, p,
                                       batchnorm=batchnorm))

        for cin in (4, 4, 2):  # rgb, normal, depth stems
            conv(cin, ngf // 2, 3, 1, 1)
            conv(ngf // 2, ngf, 4, 2, 1)
            conv(ngf, ngf * 2, 4, 2, 1)
        conv(ngf * 12, ngf * 4, 4, 2, 1)   # x4
        conv(ngf * 4, ngf * 8, 4, 2, 1)    # x5
        conv(ngf * 8, ngf * 8, 4, 2, 1)    # x6
        if self.ladder:
            conv(ngf * 8, ngf * 8, 3, 2, 0)    # x7
            conv(ngf * 8, ngf * 8, 3, 1, 1)    # x8
            conv(ngf * 8, ngf * 16, 3, 1, 0)   # x9
            deconv(ngf * 16, ngf * 8, 3, 1, 0)             # dx9
            deconv(ngf * 8 * (1 + sk), ngf * 8, 3, 1, 1)   # dx8
            deconv(ngf * 8 * (1 + sk), ngf * 8, 3, 2, 0)   # dx7
        else:
            s = (self.internal_size[0] // 32, self.internal_size[1] // 32)
            conv(ngf * 8, ngf * 16, s, 1, 0)     # x9, 1x1
            deconv(ngf * 16, ngf * 8, s, 1, 0)   # dx7
        deconv(ngf * 8 * (1 + sk), ngf * 8, 4, 2, 1)   # dx6
        deconv(ngf * 8 * (1 + sk), ngf * 4, 4, 2, 1)   # dx5
        deconv(ngf * 4 + ngf * 4 * sk, ngf * 2, 4, 2, 1)  # dx4

        # heads in the JAX order: (name, output channels, encoder skips?)
        self.head_specs = []
        ot = output_type
        if "rgb" in ot:
            self.head_specs.append(("rgb", 3, True))
        if "n" in ot.replace("rgb", ""):
            self.head_specs.append(("n", 3, True))
        if "d" in ot:
            self.head_specs.append(("d", 1, True))
        if "k" in ot:
            self.head_specs.append(("k", 1, False))
        if "s" in ot:
            self.head_specs.append(("s", snumclass, None))
        if "f" in ot:
            self.head_specs.append(("f", feature_dim, None))
        for name, out_ch, with_skips in self.head_specs:
            if with_skips is None:   # s / f: no encoder skips
                deconv(ngf * 2, ngf, 4, 2, 1)
                deconv(ngf, ngf, 4, 2, 1)
                cin = ngf
            else:
                e = sk if with_skips else 0
                deconv(ngf * 2 * (1 + e), ngf, 4, 2, 1)
                deconv(ngf * (1 + e), ngf // 2, 4, 2, 1)
                cin = ngf // 2 * (1 + e)
            heads.append(nn.Conv2d(cin, out_ch, 1))
            nn.init.xavier_normal_(heads[-1].weight)
            nn.init.zeros_(heads[-1].bias)
        self.convs = nn.ModuleList(convs)
        self.deconvs = nn.ModuleList(deconvs)
        self.heads = nn.ModuleList(heads)

    def forward(self, x, group=None):
        """x: [N, H, W, 16] NHWC -> [N, H, W, layout.num_output] in
        `dtype` (or x's dtype).  BatchNorm statistics are taken over each
        group of `group` consecutive samples (all N when None)."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        n = x.shape[0]
        g = group or n
        in_hw = x.shape[1:3]
        x = resize_nchw(x.permute(0, 3, 1, 2), self.internal_size)
        cv, dc = self.convs, self.deconvs

        def cat(*xs):
            return torch.cat(xs, dim=1)

        m, mw = x[:, 7:8], x[:, 15:16]
        # own view and warped counterpart go through the shared stems in
        # one batch: groups of g consecutive samples keep the statistics
        # of two separate calls
        stem_in = [cat(x[:, 0:3], m), cat(x[:, 3:6], m), x[:, 6:8]]
        stem_w = [cat(x[:, 8:11], mw), cat(x[:, 11:14], mw), x[:, 14:16]]
        own, skips = [], []
        for s in range(3):
            h1 = cv[3 * s](torch.cat([stem_in[s], stem_w[s]], 0), g)
            h2 = cv[3 * s + 1](h1, g)
            h3 = cv[3 * s + 2](h2, g)
            skips.append((h3[:n], h2[:n], h1[:n]))
            own.append((h3[:n], h3[n:]))
        xin = cat(own[0][0], own[0][1], own[1][0], own[1][1], own[2][0],
                  own[2][1])
        x4 = cv[9](xin, g)
        x5 = cv[10](x4, g)
        x6 = cv[11](x5, g)

        def up(feat, prev, block):
            if self.skip and prev is not None:
                feat = cat(feat, prev)
            return block(feat, g)

        if self.ladder:
            x7 = cv[12](x6, g)
            x8 = cv[13](x7, g)
            x9 = cv[14](x8, g)
            dx9 = dc[0](x9, g)
            dx8 = up(dx9, x8, dc[1])
            dx7 = up(dx8, x7, dc[2])
            d0 = 3
        else:
            dx7 = dc[0](cv[12](x6, g), g)
            d0 = 1
        dx6 = up(dx7, x6, dc[d0])
        dx5 = up(dx6, x5, dc[d0 + 1])
        dx4 = up(dx5, x4, dc[d0 + 2])

        outs = []
        stem_of = {"rgb": 0, "n": 1, "d": 2}
        for hi, (name, _, with_skips) in enumerate(self.head_specs):
            b1, b2 = dc[d0 + 3 + 2 * hi], dc[d0 + 4 + 2 * hi]
            if with_skips is None:
                d2 = b2(b1(dx4, g), g)
            else:
                s3, s2, s1 = skips[stem_of[name]] if with_skips else (
                    None, None, None)
                d2 = up(up(dx4, s3, b1), s2, b2)
                if self.skip and s1 is not None:
                    d2 = cat(d2, s1)
            head = self.heads[hi]
            o = conv2d(d2, head.weight, head.bias)
            if name == "f" and self.use_tanh:
                o = torch.tanh(o)
            outs.append(o)
        out = resize_nchw(cat(*outs), in_hw)
        return out.permute(0, 2, 3, 1)
