"""Golden tests for the torch->Flax state-dict converter.

Test-only torch ORACLES: minimal torch modules whose state_dict names
match the reference's Resnet18_8s / SCNet / segmentation_layer
(mymodel.py:41-380) so a randomly-initialized torch state dict can be
converted by utils/torch_import and the Flax output compared against the
torch forward.  These replicas exist only to validate the converter —
like tests/oracle_solver.py they must never migrate into the package.

Run small (ngf=16 / base_width=16): the map is width-independent and the
1-core CPU box can't compile the full-size nets quickly.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from relativepose_tpu.models import SCNet, Resnet18_8s, SegmentationHead
from relativepose_tpu.utils import torch_import as ti
from torch_parity import one_torch_thread  # noqa: F401


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.15)
        for m in module.modules():
            if isinstance(m, tnn.BatchNorm2d):
                if m.running_mean is not None:
                    m.running_mean.copy_(
                        torch.randn(m.running_mean.shape, generator=g) * 0.3)
                    m.running_var.copy_(
                        torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(
                    1.0 + torch.randn(m.weight.shape, generator=g) * 0.1)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)


# ---------------------------------------------------------------------------
# torch oracle: Resnet18_8s (mymodel.py:41-122), running-stats BN trunk
# ---------------------------------------------------------------------------

class _TorchBasicBlock(tnn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(cout)
        self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False),
                tnn.BatchNorm2d(cout))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + idn)


class _TorchTrunk(tnn.Module):
    """torchvision-resnet18-shaped trunk (state-dict names conv1, bn1,
    layer{1..4}.{0,1}.*) at configurable width."""

    def __init__(self, num_input, w):
        super().__init__()
        self.conv1 = tnn.Conv2d(num_input, w, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(w)
        widths = [w, 2 * w, 4 * w, 8 * w]
        cin = w
        for i, cout in enumerate(widths, start=1):
            stride = 1 if i == 1 else 2
            setattr(self, f"layer{i}", tnn.Sequential(
                _TorchBasicBlock(cin, cout, stride),
                _TorchBasicBlock(cout, cout, 1)))
            cin = cout


class _TorchResnet18_8s(tnn.Module):
    def __init__(self, num_input=7, w=16, feature_dim=32, use_tanh=True):
        super().__init__()
        self.resnet18_32s = _TorchTrunk(num_input, w)
        self.score_32s = tnn.Conv2d(8 * w, feature_dim, 1)
        self.score_16s = tnn.Conv2d(4 * w, feature_dim, 1)
        self.score_8s = tnn.Conv2d(2 * w, feature_dim, 1)
        self.use_tanh = use_tanh

    def forward(self, x):
        hw = x.shape[2:]
        t = self.resnet18_32s
        x = F.max_pool2d(F.relu(t.bn1(t.conv1(x))), 3, 2, 1)
        x = t.layer1(x)
        x = t.layer2(x)
        l8 = self.score_8s(x)
        x = t.layer3(x)
        l16 = self.score_16s(x)
        x = t.layer4(x)
        l32 = self.score_32s(x)
        up = lambda a, s: F.interpolate(a, size=s, mode="bilinear",
                                        align_corners=False)
        l16 = l16 + up(l32, l16.shape[2:])
        l8 = l8 + up(l16, l8.shape[2:])
        out = up(l8, hw)
        return torch.tanh(out) if self.use_tanh else out


def test_import_resnet18_8s_matches_torch():
    # Compare pre-tanh logits: with random (unnormalized) weights the
    # logits are large and tanh saturation turns tiny fp32 accumulation
    # differences into visible steps near zero crossings.
    tm = _TorchResnet18_8s(num_input=7, w=16, use_tanh=False)
    _randomize(tm, 0)
    tm.eval()

    x = np.random.default_rng(1).normal(
        size=(2, 7, 32, 64)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()

    net = Resnet18_8s(num_input=7, base_width=16, frozen_bn=True,
                      use_tanh=False)
    template = net.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 32, 64, 7)))["params"]
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = ti.import_resnet18_8s(sd, template=template)
    out = net.apply({"params": jax.tree.map(jnp.asarray, params)},
                    jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    out = np.transpose(np.asarray(out), (0, 3, 1, 2))
    np.testing.assert_allclose(out, ref, rtol=2e-3,
                               atol=1e-4 * float(np.abs(ref).max()))


def test_import_segmentation_head_matches_torch():
    tm = tnn.Module()
    tm.segm_layer = tnn.Conv2d(32, 15, 1)
    _randomize(tm, 2)
    x = np.random.default_rng(3).normal(
        size=(1, 32, 8, 8)).astype(np.float32)
    with torch.no_grad():
        ref = tm.segm_layer(torch.from_numpy(x)).numpy()
    head = SegmentationHead(num_classes=15)
    template = head.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8, 8, 32)))["params"]
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = ti.import_segmentation_head(sd, template=template)
    out = head.apply({"params": jax.tree.map(jnp.asarray, params)},
                     jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    np.testing.assert_allclose(
        np.transpose(np.asarray(out), (0, 3, 1, 2)), ref,
        atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# torch oracle: SCNet (mymodel.py:141-380), track_running_stats=False BNs
# ---------------------------------------------------------------------------

def _tconv(cin, cout, k, s, p):
    return tnn.Sequential(
        tnn.Conv2d(cin, cout, k, s, p, bias=False),
        tnn.BatchNorm2d(cout, track_running_stats=False),
        tnn.LeakyReLU(0.1))


def _tdeconv(cin, cout, k, s, p):
    return tnn.Sequential(
        tnn.ConvTranspose2d(cin, cout, k, s, p, bias=False),
        tnn.BatchNorm2d(cout, track_running_stats=False),
        tnn.LeakyReLU(0.1))


class _TorchSCNet(tnn.Module):
    def __init__(self, output_type="rgbdnsf", snumclass=5, feature_dim=32,
                 ngf=16, use_tanh=True):
        super().__init__()
        self.output_type, self.use_tanh = output_type, use_tanh
        for mod in ("rgb", "n", "d"):
            cin = 2 if mod == "d" else 4
            setattr(self, f"conv1{mod}", _tconv(cin, ngf // 2, 3, 1, 1))
            setattr(self, f"conv2{mod}", _tconv(ngf // 2, ngf, 4, 2, 1))
            setattr(self, f"conv3{mod}", _tconv(ngf, ngf * 2, 4, 2, 1))
        self.conv4 = _tconv(ngf * 2 * 6, ngf * 4, 4, 2, 1)
        self.conv5 = _tconv(ngf * 4, ngf * 8, 4, 2, 1)
        self.conv6 = _tconv(ngf * 8, ngf * 8, 4, 2, 1)
        self.conv7 = _tconv(ngf * 8, ngf * 8, 3, 2, 0)
        self.conv8 = _tconv(ngf * 8, ngf * 8, 3, 1, 1)
        self.conv9 = _tconv(ngf * 8, ngf * 16, 3, 1, 0)
        self.deconv9 = _tdeconv(ngf * 16, ngf * 8, 3, 1, 0)
        self.deconv8 = _tdeconv(ngf * 16, ngf * 8, 3, 1, 1)
        self.deconv7 = _tdeconv(ngf * 16, ngf * 8, 3, 2, 0)
        self.deconv6 = _tdeconv(ngf * 16, ngf * 8, 4, 2, 1)
        self.deconv5 = _tdeconv(ngf * 16, ngf * 4, 4, 2, 1)
        self.deconv4 = _tdeconv(ngf * 8, ngf * 2, 4, 2, 1)
        out_ch = {"rgb": 3, "n": 3, "d": 1, "k": 1,
                  "s": snumclass, "f": feature_dim}
        for mod in ("rgb", "n", "d", "k"):
            if mod in ("rgb",) and "rgb" not in output_type:
                continue
            if mod != "rgb" and mod not in output_type.replace("rgb", ""):
                continue
            setattr(self, f"deconv3{mod}",
                    _tdeconv(ngf * 4, ngf, 4, 2, 1))
            setattr(self, f"deconv2{mod}",
                    _tdeconv(ngf * 2, ngf // 2, 4, 2, 1))
            setattr(self, f"deconv1{mod}", tnn.Conv2d(ngf, out_ch[mod], 1))
        for mod in ("s", "f"):
            if mod in output_type:
                setattr(self, f"deconv3{mod}",
                        _tdeconv(ngf * 2, ngf, 4, 2, 1))
                setattr(self, f"deconv2{mod}", _tdeconv(ngf, ngf, 4, 2, 1))
                setattr(self, f"deconv1{mod}",
                        tnn.Conv2d(ngf, out_ch[mod], 1))

    def forward(self, x):
        hw = x.shape[2:]
        x = F.interpolate(x, size=(224, 224), mode="bilinear",
                          align_corners=False)
        enc = {}
        for half, off in (("", 0), ("_w", 8)):
            sl = x[:, off:off + 8]
            mask = sl[:, 7:8]
            ins = {"rgb": torch.cat([sl[:, 0:3], mask], 1),
                   "n": torch.cat([sl[:, 3:6], mask], 1),
                   "d": torch.cat([sl[:, 6:7], mask], 1)}
            for mod in ("rgb", "n", "d"):
                a1 = getattr(self, f"conv1{mod}")(ins[mod])
                a2 = getattr(self, f"conv2{mod}")(a1)
                a3 = getattr(self, f"conv3{mod}")(a2)
                enc[mod + half] = (a1, a2, a3)
        xin = torch.cat([enc["rgb"][2], enc["rgb_w"][2],
                         enc["n"][2], enc["n_w"][2],
                         enc["d"][2], enc["d_w"][2]], 1)
        x4 = self.conv4(xin)
        x5 = self.conv5(x4)
        x6 = self.conv6(x5)
        x7 = self.conv7(x6)
        x8 = self.conv8(x7)
        x9 = self.conv9(x8)
        dx9 = self.deconv9(x9)
        dx8 = self.deconv8(torch.cat([dx9, x8], 1))
        dx7 = self.deconv7(torch.cat([dx8, x7], 1))
        dx6 = self.deconv6(torch.cat([dx7, x6], 1))
        dx5 = self.deconv5(torch.cat([dx6, x5], 1))
        dx4 = self.deconv4(torch.cat([dx5, x4], 1))
        outs = []
        ot = self.output_type
        active = [m for m, on in (
            ("rgb", "rgb" in ot), ("n", "n" in ot.replace("rgb", "")),
            ("d", "d" in ot)) if on]
        for mod in active:
            a1, a2, a3 = enc[mod]
            d3 = getattr(self, f"deconv3{mod}")(torch.cat([dx4, a3], 1))
            d2 = getattr(self, f"deconv2{mod}")(torch.cat([d3, a2], 1))
            outs.append(getattr(self, f"deconv1{mod}")(
                torch.cat([d2, a1], 1)))
        for mod in ("s", "f"):
            if mod in ot:
                d3 = getattr(self, f"deconv3{mod}")(dx4)
                d2 = getattr(self, f"deconv2{mod}")(d3)
                o = getattr(self, f"deconv1{mod}")(d2)
                if mod == "f" and self.use_tanh:
                    o = torch.tanh(o)
                outs.append(o)
        out = torch.cat(outs, 1)
        return F.interpolate(out, size=hw, mode="bilinear",
                             align_corners=False)


@pytest.mark.slow
def test_import_scnet_matches_torch():
    ot, snc, fd, ngf = "rgbdnsf", 5, 32, 16
    tm = _TorchSCNet(output_type=ot, snumclass=snc, feature_dim=fd, ngf=ngf)
    _randomize(tm, 4)
    tm.eval()  # track_running_stats=False -> still batch stats

    x = np.random.default_rng(5).normal(
        size=(2, 16, 64, 128)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()

    net = SCNet(output_type=ot, snumclass=snc, feature_dim=fd, ngf=ngf)
    template = net.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 64, 128, 16)))["params"]
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = ti.import_scnet(sd, output_type=ot, template=template)
    out = net.apply({"params": jax.tree.map(jnp.asarray, params)},
                    jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    out = np.transpose(np.asarray(out), (0, 3, 1, 2))
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)


def test_scnet_name_map_covers_reference_modules():
    m = ti.scnet_name_map("rgbdnsf")
    expected = (
        [f"conv{i}{mod}" for mod in ("rgb", "n", "d") for i in (1, 2, 3)]
        + [f"conv{i}" for i in range(4, 10)]
        + [f"deconv{i}" for i in range(4, 10)]
        + [f"deconv{i}{mod}" for mod in ("rgb", "n", "d", "s", "f")
           for i in (1, 2, 3)])
    assert sorted(m) == sorted(expected)
    assert m["deconv1rgb"] == ("Conv_0", "plain_conv")
    assert m["deconv1f"] == ("Conv_4", "plain_conv")
    assert m["deconv3rgb"] == ("DeconvBlock_6", "deconv_block")
    # without 'k'/'s', numbering shifts
    m2 = ti.scnet_name_map("rgbdnf")
    assert m2["deconv1f"] == ("Conv_3", "plain_conv")
    assert m2["deconv3f"] == ("DeconvBlock_12", "deconv_block")


@pytest.mark.slow
def test_evaluate_cli_loads_torch_checkpoint(tmp_path, monkeypatch):
    """End-to-end: a reference-format .pth.tar (state_dict under
    'state_dict', DataParallel 'module.' prefixes) drives the evaluate
    CLI directly via --torch_comp_ckpt (evaluation.py:143-154)."""
    monkeypatch.chdir(tmp_path)
    ot, snc, fd, ngf = "rgbdnsf", 15, 32, 16
    tm = _TorchSCNet(output_type=ot, snumclass=snc, feature_dim=fd, ngf=ngf)
    _randomize(tm, 7)
    ck = tmp_path / "suncg.comp.pth.tar"
    torch.save({"epoch": 3, "state_dict": {
        f"module.{k}": v for k, v in tm.state_dict().items()}}, str(ck))

    from relativepose_tpu.cli import evaluate
    runner = evaluate.main([
        "--dataList", "synthetic", "--synthetic_family", "suncg",
        "--method", "ours_nr", "--maxIter", "2", "--batch_pairs", "2",
        "--torch_comp_ckpt", str(ck), "--ngf", str(ngf),
        "--n_detect", "32", "--exp", "torch_ck", "--rm", "--bf16", "0"])
    assert len(runner.error_stats) == 2
    for r in runner.error_stats:
        assert np.isfinite(float(r["err_ad"]))
