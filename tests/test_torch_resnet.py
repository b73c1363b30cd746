"""Resnet18_8s and SegmentationHead of relativepose_tpu_torch against the
Flax modules, on the CPU.

Small networks (base_width=8, f32) get parameters from a numpy seed,
converted in memory in both directions by `models/convert.py`.  The
shipped trained feature net `relativepose_tpu/data/pretrained/
suncg.feat.npz` (full width) runs through both packages on one 160x640
input.  Tolerance 1e-4 absolute on the features and logits (of order 1):
convolutions and BatchNorm's per-channel scaling sum in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.models import Resnet18_8s as FlaxResnet
from relativepose_tpu.models import SegmentationHead as FlaxSeg
from relativepose_tpu.utils.checkpoint import load_params_npz as jload
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.resnet import Resnet18_8s, SegmentationHead
from relativepose_tpu_torch.utils.checkpoint import load_params_npz
from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
SHIPPED = os.path.join(os.path.dirname(__file__), "..", "relativepose_tpu",
                       "data", "pretrained", "suncg.feat.npz")


def random_params(net, x, seed):
    """Flax params from a numpy seed: kernels ~ N(0, 1/fan_in), BatchNorm
    scale (weight - 1) and biases ~ N(0, 0.05)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), x)["params"]

    def fill(path, s):
        if "kernel" in jax.tree_util.keystr(path):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("use_tanh", [True, False])
def test_resnet_matches_flax(rng, use_tanh):
    x = rng.randn(3, 160, 640, 7).astype(np.float32)
    net = FlaxResnet(base_width=8, use_tanh=use_tanh)
    params = random_params(net, jnp.asarray(x), 1)
    yj = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    tnet = convert.load_flax_params(
        Resnet18_8s(base_width=8, use_tanh=use_tanh), params)
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x)).numpy()
    assert yt.shape == yj.shape == (3, 160, 640, 32)
    np.testing.assert_allclose(yt, yj, atol=TOL)


def test_frozen_bn_matches_flax(rng):
    x = rng.randn(2, 96, 128, 7).astype(np.float32)
    net = FlaxResnet(base_width=8, frozen_bn=True)
    params = random_params(net, jnp.asarray(x), 2)
    yj = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    tnet = convert.load_flax_params(Resnet18_8s(base_width=8, frozen_bn=True),
                                    params)
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, atol=TOL)


def test_segmentation_head_matches_flax(rng):
    f = rng.randn(2, 20, 40, 32).astype(np.float32)
    head = FlaxSeg(num_classes=15)
    params = random_params(head, jnp.asarray(f), 3)
    yj = np.asarray(head.apply({"params": params}, jnp.asarray(f)))
    thead = convert.load_flax_params(SegmentationHead(32, 15), params)
    with torch.no_grad():
        np.testing.assert_allclose(thead(torch.from_numpy(f)).numpy(), yj,
                                   atol=TOL)


@pytest.mark.parametrize("kind", ["resnet", "seg"])
def test_torch_to_flax_tree_round_trip(rng, kind):
    """A port module -> the Flax tree -> the Flax module gives the port's
    outputs, and the tree loads back into the port bit for bit (up to
    the BatchNorm scale's weight - 1 offset, one f32 rounding)."""
    torch.manual_seed(0)
    if kind == "resnet":
        tnet, fnet = Resnet18_8s(base_width=8), FlaxResnet(base_width=8)
        x = rng.randn(2, 64, 128, 7).astype(np.float32)
    else:
        tnet, fnet = SegmentationHead(32, 15), FlaxSeg(num_classes=15)
        x = rng.randn(2, 8, 16, 32).astype(np.float32)
    tree = convert.flax_params(tnet)
    yj = np.asarray(fnet.apply({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(yt, yj, atol=TOL)
    back = type(tnet)(**({"base_width": 8} if kind == "resnet" else
                         {"feature_dim": 32, "num_classes": 15}))
    convert.load_flax_params(back, tree)
    for (k, a), b in zip(tnet.state_dict().items(),
                         back.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-7,
                                   err_msg=k)


def test_bf16_forward_is_finite(rng):
    torch.manual_seed(0)
    net = Resnet18_8s(base_width=8, dtype=torch.bfloat16)
    x = torch.from_numpy(rng.randn(2, 160, 640, 7).astype(np.float32))
    with torch.no_grad():
        y = net(x)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 160, 640, 32)
    assert torch.isfinite(y.float()).all()


def test_shipped_feature_net_matches_flax(rng):
    """The trained suncg feature net (full width) through both packages,
    one 160x640 input from a synthetic suncg view."""
    from relativepose_tpu_torch.data import synthetic
    view, _, _ = synthetic.make_pair(3, "suncg", full_frames=False)
    x = np.concatenate([view["rgb"], view["norm"], view["depth"][..., None]],
                       -1)[None].astype(np.float32)
    params = jload(SHIPPED)["net_f"]
    yj = np.asarray(FlaxResnet().apply({"params": params}, jnp.asarray(x)))
    tnet = convert.load_flax_params(Resnet18_8s(),
                                    load_params_npz(SHIPPED)["net_f"])
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x)).numpy()
    assert np.isfinite(yt).all() and yt.std() > 0.05
    np.testing.assert_allclose(yt, yj, atol=TOL)
