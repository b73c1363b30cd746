"""SCNet of relativepose_tpu_torch against the Flax SCNet, on the CPU.

A small Flax SCNet (ngf=8, f32) is built in the test with parameters from
a numpy seed; they are converted in memory with the port's converter, and
both networks run on the same numpy input.  Tolerance 5e-4 absolute on
outputs of order 1-10: the convolutions sum in another order and
BatchNorm divides by per-channel standard deviations, which amplifies that
rounding."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.models.blocks import resize_bilinear as jresize
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.blocks import resize_bilinear
from relativepose_tpu_torch.models.scnet import SCNet
from torch_parity import flax_scnet_params
from torch_parity import one_torch_thread  # noqa: F401

TOL = 5e-4


def t(x):
    return torch.from_numpy(np.array(x))


def flax_net(internal_size, output_type="rgbdnsf"):
    net = FlaxSCNet(ngf=8, internal_size=internal_size,
                    output_type=output_type)
    return net, flax_scnet_params(net)


@pytest.mark.parametrize("internal_size", [(224, 224), (64, 128)])
def test_converted_scnet_matches_flax(rng, internal_size):
    """Both bottlenecks: the 224 ladder and the generalized one."""
    net, params = flax_net(internal_size)
    x = rng.randn(2, 160, 640, 16).astype(np.float32)
    yj = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    tnet = convert.load_flax_params(SCNet(ngf=8, internal_size=internal_size),
                                    params)
    with torch.no_grad():
        yt = tnet(t(x), group=2).numpy()
    assert yt.shape == yj.shape == (2, 160, 640, 54)
    np.testing.assert_allclose(yj, yt, atol=TOL)


def test_output_type_with_k_head(rng):
    net, params = flax_net((64, 64), "rgbdnkf")
    x = rng.randn(2, 160, 640, 16).astype(np.float32)
    yj = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    tnet = convert.load_flax_params(
        SCNet(ngf=8, internal_size=(64, 64), output_type="rgbdnkf"), params)
    with torch.no_grad():
        np.testing.assert_allclose(yj, tnet(t(x)).numpy(), atol=TOL)


def test_batch_equals_single_pair_calls(rng):
    """BatchNorm statistics per pair: a batch of 3 pairs gives what 3
    single-pair calls give (same arithmetic per sample; 1e-5 for the
    convolution's batch-size-dependent blocking)."""
    torch.manual_seed(0)
    net = SCNet(ngf=8, internal_size=(64, 64)).eval()
    x = t(rng.randn(6, 160, 640, 16).astype(np.float32))
    with torch.no_grad():
        y = net(x, group=2)
        singles = torch.cat([net(x[i:i + 2]) for i in (0, 2, 4)])
    torch.testing.assert_close(y, singles, rtol=0, atol=1e-5)


def test_flat_dict_and_flax_tree_convert_alike():
    _, params = flax_net((64, 64))
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(key, v)
            else:
                flat[key] = np.asarray(v)

    walk("params", params)
    a = convert.scnet_state_dict(params)
    b = convert.scnet_state_dict(flat)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # the shipped npz files hold f16: read as f32
    half = convert.scnet_state_dict(
        {k: v.astype(np.float16) for k, v in flat.items()})
    assert all(v.dtype == torch.float32 for v in half.values())


def test_resize_bilinear(rng):
    """The port's resize equals the JAX package's interpolation matrices
    (1e-5) and, up and down, torch's own bilinear resize without
    antialias; the latter to 1e-3 only, because torch computes the source
    coordinates in f32 (an error of ~6e-5 px at x ~ 600, times values of
    order 3) where the matrices are built in f64."""
    x = rng.randn(2, 160, 640, 3).astype(np.float32)
    for size in ((224, 224), (320, 1280)):
        y = resize_bilinear(t(x), size)
        np.testing.assert_allclose(np.asarray(jresize(jnp.asarray(x), size)),
                                   y.numpy(), atol=1e-5)
        ref = F.interpolate(t(x).permute(0, 3, 1, 2), size=size,
                            mode="bilinear", align_corners=False,
                            antialias=False).permute(0, 2, 3, 1)
        torch.testing.assert_close(y, ref, rtol=0, atol=1e-3)


def test_bf16_forward_is_finite(rng):
    torch.manual_seed(0)
    net = SCNet(ngf=8, internal_size=(64, 64), dtype=torch.bfloat16).eval()
    with torch.no_grad():
        y = net(t(rng.randn(2, 160, 640, 16).astype(np.float32)))
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())


@pytest.mark.slow
def test_shipped_weights_load_strictly():
    """The full-width converter on a shipped npz, read in place."""
    path = os.path.join(os.path.dirname(__file__), "..", "relativepose_tpu",
                        "data", "pretrained", "suncg.comp_ft.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    net = convert.load_flax_params(SCNet(ngf=64), flat)
    assert sum(p.numel() for p in net.parameters()) > 10_000_000


@pytest.fixture(scope="module")
def shipped_comp():
    """(input, Flax f32 output, converted port SCNet) of the shipped
    trained completion net `suncg.comp.npz` (full width, the checkpoint
    the JAX package's pose fine-tuning starts from), converted in memory,
    on one seeded input."""
    from relativepose_tpu.utils.checkpoint import load_params_npz as jload
    from relativepose_tpu_torch.utils.checkpoint import load_params_npz
    path = os.path.join(os.path.dirname(__file__), "..", "relativepose_tpu",
                        "data", "pretrained", "suncg.comp.npz")
    x = np.random.RandomState(0).randn(2, 160, 640, 16).astype(np.float32)
    yj = np.asarray(FlaxSCNet(ngf=64).apply({"params": jload(path)},
                                             jnp.asarray(x)))
    tnet = convert.load_flax_params(SCNet(ngf=64), load_params_npz(path))
    return x, yj, tnet


def forward(net, x, dtype=torch.float32):
    with torch.no_grad():
        return net(t(x).to(dtype), group=2).double().numpy()


def test_shipped_comp_weights_forward_matches_flax(shipped_comp):
    """The shipped completion net against the Flax SCNet, f32, BatchNorm
    per pair, on torch's default CPU convolution (oneDNN).

    Bounds from measurement: relative L2 2e-4 (measured 9.4e-5), median
    |difference| 1e-4 (1.8e-5), max 0.1 (0.041, on outputs up to 12.4).
    The 1x1 bottleneck normalises 2 values per channel (one pair), which
    amplifies the rounding of the conv before it about a thousandfold,
    and oneDNN's f32 convolution rounds worse than XLA's there: its
    output is 0.042 from the port's f64-convolution evaluation at most,
    where the port on torch's native convolution is 2.2e-3 from it and
    the JAX package 1.2e-3
    (`test_shipped_comp_weights_native_conv_and_f64_convolutions` holds
    those)."""
    x, yj, tnet = shipped_comp
    yt = forward(tnet, x)
    assert yt.shape == yj.shape == (2, 160, 640, 54)
    assert np.isfinite(yt).all() and yt.std() > 0.05
    d = np.abs(yt - yj)
    assert np.linalg.norm(yt - yj) <= 2e-4 * np.linalg.norm(yj)
    assert np.median(d) <= 1e-4 and d.max() <= 0.1


def test_shipped_comp_weights_native_conv_and_f64_convolutions(
        shipped_comp):
    """The same forward with oneDNN turned off, and with f64 parameters
    and activations.

    The port's BatchNorm takes its statistics in f32 outside a process
    group, also for f64 activations, so this is the network with f64
    convolutions, not the f64 function.  It is within the JAX package's
    own f32 error of the Flax output (relative L2 1e-5, measured 3.7e-6;
    max 2e-3, measured 1.2e-3), so the conversion and the per-pair
    BatchNorm are right.  (The f64 function itself: with f64 statistics
    the port's output is 1.6e-9 relative L2 from the Flax SCNet's under
    `jax.enable_x64` with the float32 of its BatchNorm rebound to
    float64, `torch_parity.flax_f64`; both packages' f32 outputs are
    2.1e-5 from it.  The port keeps f32 statistics: f64 ones move the f64
    sharded evaluation of `tests/test_torch_mesh.py` from 5.5e-6 to
    1.7e-5 of the 1-rank poses, ROADMAP queue C.)  On torch's native
    convolution the port's f32 output is as close to the Flax one as the
    two packages' f32 rounding allows: relative L2 2e-5 (measured
    8.2e-6), median 1e-5 (3.8e-6), max 3e-3 (1.4e-3), with 2 threads or
    more (torch's native convolution on one thread rounds otherwise: max
    0.022).  The 1e-4 max bound is out of reach of either package's f32
    at this width."""
    x, yj, tnet = shipped_comp
    y64 = forward(copy.deepcopy(tnet).double(), x, torch.float64)
    assert np.linalg.norm(y64 - yj) <= 1e-5 * np.linalg.norm(y64)
    assert np.abs(y64 - yj).max() <= 2e-3
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            yt = forward(tnet, x)
    finally:
        torch.set_num_threads(threads)
    d = np.abs(yt - yj)
    assert np.linalg.norm(yt - yj) <= 2e-5 * np.linalg.norm(yj)
    assert np.median(d) <= 1e-5 and d.max() <= 3e-3
