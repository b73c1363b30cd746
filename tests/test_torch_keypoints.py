"""Keypoints of relativepose_tpu_torch against relativepose_tpu, on the CPU.

Both packages get the same numpy inputs and the same random draws (the
JAX package's `jax.random` draws, handed to the port).  Integer outputs
(NMS picks, keypoint positions, validity) must match exactly; f32 values
are held to 1e-5 absolute (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.match import keypoints as jkp
from relativepose_tpu.match import primitives as jprim
from relativepose_tpu.ops import interpolate as jinterp
from relativepose_tpu.ops import sampling as jsamp
from relativepose_tpu_torch.data import synthetic
from relativepose_tpu_torch.match import keypoints as tkp
from relativepose_tpu_torch.match import primitives as tprim
from relativepose_tpu_torch.ops import interpolate as tinterp
from relativepose_tpu_torch.ops import sampling as tsamp
from torch_parity import batch_draws, jax_choice, jax_keypoint_draws
from torch_parity import one_torch_thread  # noqa: F401

SMALL = dict(n_detect=32, n_match=16, n_random=8)


def t(x):
    return torch.from_numpy(np.array(x))


def observed_gray(seed):
    ds, _, _ = synthetic.make_pair(seed, "suncg", max_baseline=0.5)
    return (jkp.rgb_to_gray(ds["rgb"] * 255.0)[:, 160:320]).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_dog(seed):
    """Same corners on a synthetic observed face.  Equal responses would
    be ordered by index on both sides (stable top-k), but responses that
    differ only by the convolutions' rounding may swap places, so the
    valid keypoints are compared as sets."""
    gray = observed_gray(seed)
    pj, vj = jkp.detect_dog(jnp.asarray(gray), 64)
    pt_, vt = tkp.detect_dog(t(gray)[None], 64)
    pj, vj = np.asarray(pj), np.asarray(vj)
    assert vj.sum() == vt.sum() > 10
    assert {tuple(p) for p in pj[vj]} == {tuple(p) for p in
                                          pt_[0][vt[0]].numpy()}


def test_detect_dog_flat_image_finds_nothing():
    pts, valid = tkp.detect_dog(torch.full((2, 160, 160), 240.0), 16)
    assert not valid.any() and pts.shape == (2, 16, 2)


@pytest.mark.parametrize("k", [2, 5])
def test_topk_nms_exact(rng, k):
    maps = rng.rand(6, 40, 64).astype(np.float32)
    maps[0, :] = 0.5  # a flat map: ties resolve to the first index
    pj = np.asarray(jsamp.topk_nms(jnp.asarray(maps), k))
    pt_ = tsamp.topk_nms(t(maps), k).numpy()
    np.testing.assert_array_equal(pj, pt_)


def test_interpolate(rng):
    feat = rng.randn(2, 20, 30, 5).astype(np.float32)
    pts = rng.rand(2, 40, 2).astype(np.float32)
    out = tinterp.interpolate_normalized(t(feat), t(pts)).numpy()
    for b in range(2):
        np.testing.assert_allclose(
            np.asarray(jinterp.interpolate_normalized(
                jnp.asarray(feat[b]), jnp.asarray(pts[b]))), out[b],
            atol=1e-5)


def test_distance_heatmaps(rng):
    q = rng.randn(2, 7, 8).astype(np.float32)
    feat = rng.randn(2, 12, 16, 8).astype(np.float32)
    d = tkp._distance_heatmaps(t(q), t(feat)).numpy()
    for b in range(2):
        # squared distances of order 16: 1e-4 is a few f32 ulps
        np.testing.assert_allclose(
            np.asarray(jkp._distance_heatmaps(jnp.asarray(q[b]),
                                              jnp.asarray(feat[b]))),
            d[b], atol=1e-4)


def test_augment_with_feature_matches(rng):
    desc = rng.randn(20, 8).astype(np.float32)
    valid = rng.rand(20) > 0.3
    feat = rng.randn(40, 64, 8).astype(np.float32)
    key = jax.random.PRNGKey(6)
    pj, vj = jkp.augment_with_feature_matches(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(feat), key, 6)
    sel = np.asarray(jax_choice(key, jnp.asarray(valid), 6))[None]
    pt_, vt = tkp.augment_with_feature_matches(
        t(desc)[None], t(valid)[None], t(feat)[None], t(sel))
    np.testing.assert_array_equal(np.asarray(pj), pt_[0].numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt[0].numpy())


def test_random_unobserved_points_from_jax_uniforms():
    key = jax.random.PRNGKey(3)
    pj, vj = jkp.random_unobserved_points(key, 30, "second")
    kx, ky = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(kx, (30,))),
                  np.asarray(jax.random.uniform(ky, (30,)))])[None]
    pt_, vt = tkp.random_unobserved_points(t(u), "second")
    np.testing.assert_array_equal(np.asarray(pj), pt_[0].numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt[0].numpy())


def _pair_inputs(seed, rng):
    ds, dt, _ = synthetic.make_pair(seed, "suncg", max_baseline=0.5)
    mask = np.zeros((160, 640, 1), np.float32)
    mask[:, 160:320] = 1.0
    rgb_s = (mask * ds["rgb"] * 255.0).astype(np.float32)
    rgb_t = (mask * dt["rgb"] * 255.0).astype(np.float32)
    feat_s = rng.randn(160, 640, 8).astype(np.float32)
    feat_t = rng.randn(160, 640, 8).astype(np.float32)
    return ds, dt, rgb_s, rgb_t, feat_s, feat_t


def test_build_keypoint_sets_with_jax_draws(rng):
    """The same draws give the same keypoint sets, exactly."""
    _, _, rgb_s, rgb_t, feat_s, feat_t = _pair_inputs(7, rng)
    jcfg, tcfg = jkp.KeypointConfig(**SMALL), tkp.KeypointConfig(**SMALL)
    key = jax.random.PRNGKey(11)
    out_j = jkp.build_keypoint_sets(
        jnp.asarray(rgb_s), jnp.asarray(rgb_t), jnp.asarray(feat_s),
        jnp.asarray(feat_t), key, jcfg)
    det_s = jkp.detect_observed(jnp.asarray(rgb_s), jcfg)
    det_t = jkp.detect_observed(jnp.asarray(rgb_t), jcfg)
    draws = batch_draws([jax_keypoint_draws(key, det_s[1], det_t[1], jcfg)])
    out_t = tkp.build_keypoint_sets(
        t(rgb_s)[None], t(rgb_t)[None], t(feat_s)[None], t(feat_t)[None],
        tcfg, draws=draws)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
    assert out_t[1].sum() > 20


def test_keypoint_sets_drawn_from_generator(rng):
    _, _, rgb_s, rgb_t, feat_s, feat_t = _pair_inputs(8, rng)
    cfg = tkp.KeypointConfig(**SMALL)
    args = [t(np.stack([a, a])) for a in (rgb_s, rgb_t, feat_s, feat_t)]
    outs = [tkp.build_keypoint_sets(
        *args, cfg, generator=torch.Generator().manual_seed(5))
        for _ in range(2)]
    # the generator's draws are those of `draw_keypoints`, the one place
    # that knows their order
    det = [tkp.detect_observed(a, cfg) for a in args[:2]]
    draws = tkp.draw_keypoints(det[0][1], det[1][1], cfg,
                               generator=torch.Generator().manual_seed(5))
    outs.append(tkp.build_keypoint_sets(*args, cfg, draws=draws))
    for a, b, c in zip(*outs):
        assert a.shape[:2] == (2, cfg.capacity)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_extract_primitives_with_jax_draws(rng):
    ds, dt, rgb_s, rgb_t, feat_s, feat_t = _pair_inputs(9, rng)
    jcfg, tcfg = jkp.KeypointConfig(**SMALL), tkp.KeypointConfig(**SMALL)
    key = jax.random.PRNGKey(2)
    geo = [ds["depth"], dt["depth"], ds["norm"], dt["norm"]]
    pj = jprim.extract_primitives(
        jnp.asarray(rgb_s), jnp.asarray(rgb_t), *map(jnp.asarray, geo),
        jnp.asarray(feat_s), jnp.asarray(feat_t), key, jcfg, "suncg")
    det_s = jkp.detect_observed(jnp.asarray(rgb_s), jcfg)
    det_t = jkp.detect_observed(jnp.asarray(rgb_t), jcfg)
    draws = batch_draws([jax_keypoint_draws(key, det_s[1], det_t[1], jcfg)])
    pt_ = tprim.extract_primitives(
        t(rgb_s)[None], t(rgb_t)[None],
        *[t(g).float()[None] for g in geo], t(feat_s)[None],
        t(feat_t)[None], tcfg, "suncg", draws=draws)
    for dj, dtt in zip(pj, pt_):
        for k in dj:
            np.testing.assert_allclose(np.asarray(dj[k]), dtt[k][0].numpy(),
                                       atol=1e-5, err_msg=k)
