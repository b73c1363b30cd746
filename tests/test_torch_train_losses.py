"""The port's training losses against relativepose_tpu.train.losses, on
the CPU.

The same seeded numpy features and correspondences go to both packages,
and the JAX package's negative draws (its `jax.random.randint` calls
under the same key) are handed to the port.  Tolerance 1e-5 relative and
1e-6 absolute on the loss values: both sum the same f32 terms in another
order; the hard-mined loss takes its negatives by a top-k over distances
from a matmul, whose rounding can swap near-equal candidates, which moves
the sum by less than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.train import losses as jl
from relativepose_tpu_torch.train import losses as tl
from torch_parity import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
N, H, W, C, K = 2, 24, 48, 8, 50


def t(x):
    return torch.from_numpy(np.array(x))


def features(rng):
    fs = np.tanh(rng.randn(N, H, W, C)).astype(np.float32)
    ft = np.tanh(fs + 0.3 * rng.randn(N, H, W, C)).astype(np.float32)
    return fs, ft


def dense(rng, valid):
    src = np.stack([rng.randint(0, W, (N, K)), rng.randint(0, H, (N, K))],
                   -1).astype(np.int32)
    tgt = np.stack([rng.randint(0, W, (N, K)), rng.randint(0, H, (N, K))],
                   -1).astype(np.int32)
    return {"idx_src": src, "idx_tgt": tgt,
            "valid": np.asarray(valid, np.int32)}


def jax_negatives(key, hard, n_neg=100, n_candidates=1024):
    """The draws `contrastive_loss` makes from `key`."""
    ky, kx = jax.random.split(key)
    shape = (N, n_candidates) if hard else (N, K, n_neg)
    return tl.NegativeDraws(
        t(jax.random.randint(ky, shape, 0, H)).long(),
        t(jax.random.randint(kx, shape, 0, W)).long())


@pytest.mark.parametrize("valid", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("hard", [False, True])
def test_contrastive_loss_matches_jax(rng, hard, valid):
    fs, ft = features(rng)
    d = dense(rng, valid)
    key = jax.random.PRNGKey(3)
    yj = jl.contrastive_loss(jnp.asarray(fs), jnp.asarray(ft),
                             {k: jnp.asarray(v) for k, v in d.items()}, key,
                             margin=0.5, hard_negatives=hard)
    yt = tl.contrastive_loss(t(fs), t(ft), {k: t(v) for k, v in d.items()},
                             jax_negatives(key, hard), margin=0.5,
                             hard_negatives=hard)
    for a, b in zip(yj, yt):
        np.testing.assert_allclose(float(b), float(a), rtol=RTOL, atol=ATOL)
    if valid == (0, 0):
        assert float(yt[0]) == 0.0


def test_contrastive_gradients_match_jax(rng):
    """Gradients w.r.t. both feature maps (hard mining), same tolerance
    scaled to the gradient's size."""
    fs, ft = features(rng)
    d = dense(rng, (1, 1))
    key = jax.random.PRNGKey(5)
    gj = jax.grad(lambda a, b: jl.contrastive_loss(
        a, b, {k: jnp.asarray(v) for k, v in d.items()}, key,
        hard_negatives=True)[0], argnums=(0, 1))(jnp.asarray(fs),
                                                 jnp.asarray(ft))
    a, b = t(fs).requires_grad_(), t(ft).requires_grad_()
    tl.contrastive_loss(a, b, {k: t(v) for k, v in d.items()},
                        jax_negatives(key, True), hard_negatives=True)[
        0].backward()
    for x, y in zip(gj, (a.grad, b.grad)):
        scale = float(np.abs(np.asarray(x)).max())
        np.testing.assert_allclose(y.numpy(), np.asarray(x),
                                   atol=1e-5 * scale)


def test_masked_l1_ce_and_feature_consistency_match_jax(rng):
    pred = rng.randn(2, 16, 32, 15).astype(np.float32)
    target = rng.randn(2, 16, 32, 15).astype(np.float32)
    weight = (rng.rand(2, 16, 32, 1) > 0.3).astype(np.float32)
    labels = rng.randint(0, 15, (2, 16, 32))
    geow = rng.rand(2, 16, 32, 1).astype(np.float32)
    pairs = [
        (jl.masked_l1(*map(jnp.asarray, (pred, target, weight))),
         tl.masked_l1(t(pred), t(target), t(weight))),
        (jl.weighted_ce(jnp.asarray(pred), jnp.asarray(labels),
                        jnp.asarray(weight)),
         tl.weighted_ce(t(pred), t(labels), t(weight))),
        (jl.feature_consistency_loss(*map(jnp.asarray,
                                          (pred, target, weight, geow))),
         tl.feature_consistency_loss(t(pred), t(target), t(weight),
                                     t(geow))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(float(b), float(a), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dataset", ["suncg", "matterport"])
def test_plane_normal_loss_matches_jax(rng, dataset):
    depth = (1.0 + 3.0 * rng.rand(2, 160, 640)).astype(np.float32)
    depth[:, :, :40] = 0.0
    normal = rng.randn(2, 160, 640, 3).astype(np.float32)
    plane = (rng.randn(2, 160, 640) * 4.0).astype(np.float32)
    plane[:, 50:60] = 0.0
    a = jl.plane_normal_loss(jnp.asarray(depth), jnp.asarray(normal),
                             jnp.asarray(plane), dataset)
    b = tl.plane_normal_loss(t(depth), t(normal), t(plane), dataset)
    np.testing.assert_allclose(float(b), float(a), rtol=RTOL, atol=ATOL)


def test_plane_normal_loss_rejects_scannet():
    z = torch.zeros(1, 160, 640)
    with pytest.raises(NotImplementedError):
        tl.plane_normal_loss(z, torch.zeros(1, 160, 640, 3), z, "scannet")


def test_gather_truncates_like_astype():
    feat = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4, 1)
    idx = torch.tensor([[[1.9, 2.7]], [[3.2, 0.5]]])
    got = tl._gather_feat(feat, idx)[..., 0]
    jgot = jl._gather_feat(jnp.asarray(feat.numpy()),
                           jnp.asarray(idx.numpy()))[..., 0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
