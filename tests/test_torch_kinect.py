"""The ScanNet kinect path of relativepose_tpu_torch against relativepose_tpu,
on the CPU: the kinect mask, the kinect lifts, the scannet warp and the
keypoints detected on the 480x640 frame.

Tolerances: masks, splat winners, DoG picks, keypoint positions and
validity are integer or exact results and must be equal; f32 lifts that
divide by the kinect factors are held to 1e-6 relative (one rounding of a
division), other f32 values to 1e-5 absolute, as in
tests/test_torch_geometry.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu import config as jconfig
from relativepose_tpu.core import masking as jmask
from relativepose_tpu.core import skybox as jsky
from relativepose_tpu.match import keypoints as jkp
from relativepose_tpu.match import primitives as jprim
from relativepose_tpu_torch import config
from relativepose_tpu_torch.core import masking as tmask
from relativepose_tpu_torch.core import skybox as tsky
from relativepose_tpu_torch.data import synthetic
from relativepose_tpu_torch.match import keypoints as tkp
from relativepose_tpu_torch.match import primitives as tprim
from torch_parity import batch_draws, jax_keypoint_draws
from torch_parity import one_torch_thread  # noqa: F401

SMALL = dict(n_detect=32, n_match=16, n_random=8)
FACE = config.FACE


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("variant", ["eval", "train"])
def test_kinect_mask(rng, variant):
    """The 66x88 window centred in the second face; geow 1 - mask for
    'eval', 20 inside and 1 outside for 'train'."""
    mj, gj = jmask.observation_mask("kinect", variant)
    mt, gt = tmask.observation_mask("kinect", "cpu", variant)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    assert mt.sum() == config.KINECT_FOV_W * config.KINECT_FOV_H
    assert mt[80, 240] == 1 and mt[0, 0] == 0
    assert gt[80, 240] == (20.0 if variant == "train" else 0.0)
    assert gt[0, 0] == 1.0
    x = rng.rand(2, 160, 640, 7).astype(np.float32)
    for a, b in zip(jmask.apply_mask(jnp.asarray(x), "kinect", variant),
                    tmask.apply_mask(t(x), "kinect", variant)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_scannet_pano_lift(rng):
    depth = (rng.rand(2, 160, 640) * 3).astype(np.float32)
    depth[:, ::7] = 0.0
    pj, vj = jsky.pano_to_pointcloud(jnp.asarray(depth), "scannet")
    pt_, vt = tsky.pano_to_pointcloud(t(depth), "scannet")
    np.testing.assert_allclose(np.asarray(pj), pt_.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_scannet_resplat_contraction():
    """Mirrors the JAX package's test: the scannet lift divides the NDC by
    the kinect factors while the splat projects plainly, so a lifted pixel
    re-splats at contracted coordinates with the same depth; both packages
    splat the same depth image."""
    depth = np.full((1, FACE, 4 * FACE), 2.5, np.float32)
    pts, valid = tsky.pano_to_pointcloud(t(depth), "scannet")
    _, d2 = tsky.splat_to_pano(pts, torch.zeros(pts.shape[:-1] + (1,)),
                               valid, "scannet", 1)
    d2 = d2[0].numpy()
    x, y = FACE + 40, 80
    ndc_x = ((x - FACE) / FACE - 0.5) * 2 / config.KINECT_FX_DIV
    ndc_y = (0.5 - y / FACE) * 2 / config.KINECT_FY_DIV
    u = int(np.round((ndc_x + 1) * 0.5 * FACE)) + FACE
    v = int(np.round((1 - ndc_y) * 0.5 * FACE))
    assert d2[v, u] == pytest.approx(2.5, rel=1e-4)
    assert d2[80, FACE + 80] > 0 and d2[80, FACE + 2] == 0
    pj, vj = jsky.pano_to_pointcloud(jnp.asarray(depth[0]), "scannet")
    _, dj = jsky.splat_to_pano(pj, jnp.zeros((pj.shape[0], 1)), vj,
                               "scannet", 1)
    np.testing.assert_array_equal(np.asarray(dj), d2)


def test_kinect_crop_and_full_lifts(rng):
    crop = (rng.rand(2, config.KINECT_FOV_H, config.KINECT_FOV_W) * 3
            ).astype(np.float32)
    crop[:, ::5] = 0.0
    full = (rng.rand(2, config.KINECT_FULL_H, config.KINECT_FULL_W) * 3
            ).astype(np.float32)
    full[:, :, ::9] = 0.0
    for jfn, tfn, d in ((jsky.kinect_crop_to_pointcloud,
                         tsky.kinect_crop_to_pointcloud, crop),
                        (jsky.kinect_full_to_pointcloud,
                         tsky.kinect_full_to_pointcloud, full)):
        pt_, vt = tfn(t(d))
        for b in range(2):
            pj, vj = jfn(jnp.asarray(d[b]))
            np.testing.assert_allclose(np.asarray(pj), pt_[b].numpy(),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(np.asarray(vj), vt[b].numpy())
    assert pt_.shape == (2, config.KINECT_FULL_H * config.KINECT_FULL_W, 3)


def test_kinect_observed_region_and_random_points(rng):
    pts = np.stack([rng.uniform(0, 640, 500), rng.uniform(0, 160, 500)],
                   -1).astype(np.float32)
    pts[:4] = [[config.KINECT_COL0, config.KINECT_ROW0],
               [config.KINECT_COL1, config.KINECT_ROW1],
               [config.KINECT_COL0 - 1, 80], [200, config.KINECT_ROW1 + 1]]
    np.testing.assert_array_equal(
        np.asarray(jkp.in_observed_region(jnp.asarray(pts), "kinect")),
        tkp.in_observed_region(t(pts), "kinect").numpy())
    key = jax.random.PRNGKey(8)
    pj, vj = jkp.random_unobserved_points(key, 30, "kinect")
    kx, ky = jax.random.split(key)
    u = np.stack([np.asarray(jax.random.uniform(kx, (30,))),
                  np.asarray(jax.random.uniform(ky, (30,)))])[None]
    pt_, vt = tkp.random_unobserved_points(t(u), "kinect")
    np.testing.assert_array_equal(np.asarray(pj), pt_[0].numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt[0].numpy())
    assert tkp.N_RANDOM_KINECT == jkp.N_RANDOM_KINECT == 120
    with pytest.raises(ValueError):
        tkp.in_observed_region(t(pts), "third")


@pytest.fixture(scope="module")
def scannet_pair():
    ds, dt, _ = synthetic.make_pair(3, "scannet", max_baseline=0.5)
    mask = np.asarray(jmask.observation_mask("kinect")[0])[..., None]
    rgb_s = (mask * ds["rgb"] * 255.0).astype(np.float32)
    rgb_t = (mask * dt["rgb"] * 255.0).astype(np.float32)
    gray_s = np.asarray(jkp.rgb_to_gray(ds["rgb_full"] * 255.0), np.float32)
    gray_t = np.asarray(jkp.rgb_to_gray(dt["rgb_full"] * 255.0), np.float32)
    return ds, dt, rgb_s, rgb_t, gray_s, gray_t


def test_detect_on_full_frame(scannet_pair):
    """DoG on the 480x640 frame, remapped into the kinect window.  As in
    tests/test_torch_keypoints.py the valid picks are compared as sets
    (responses that differ by convolution rounding may swap places)."""
    _, _, rgb_s, _, gray_s, _ = scannet_pair
    cfg = jkp.KeypointConfig()
    pj, vj = jkp.detect_observed(jnp.asarray(rgb_s), cfg,
                                 jnp.asarray(gray_s))
    pt_, vt = tkp.detect_observed(t(rgb_s)[None], tkp.KeypointConfig(),
                                  t(gray_s)[None])
    pj, vj = np.asarray(pj), np.asarray(vj)
    assert vj.sum() == vt.sum() > 20
    assert {tuple(p) for p in pj[vj]} == {tuple(p) for p in
                                          pt_[0][vt[0]].numpy()}
    inside = tkp.in_observed_region(pt_[0][vt[0]], "kinect")
    assert bool(inside.all())


def test_kinect_keypoints_and_primitives_with_jax_draws(scannet_pair, rng):
    """The same draws give the same kinect keypoint sets, exactly, and
    the same scannet primitives to 1e-5.  C stays n_detect + 2 n_match +
    2 n_random: like the JAX package, the kinect path does not use
    N_RANDOM_KINECT."""
    ds, dt, rgb_s, rgb_t, gray_s, gray_t = scannet_pair
    feat_s = rng.randn(160, 640, 8).astype(np.float32)
    feat_t = rng.randn(160, 640, 8).astype(np.float32)
    jcfg, tcfg = jkp.KeypointConfig(**SMALL), tkp.KeypointConfig(**SMALL)
    key = jax.random.PRNGKey(12)
    det_s = jkp.detect_observed(jnp.asarray(rgb_s), jcfg,
                                jnp.asarray(gray_s))
    det_t = jkp.detect_observed(jnp.asarray(rgb_t), jcfg,
                                jnp.asarray(gray_t))
    draws = batch_draws([jax_keypoint_draws(key, det_s[1], det_t[1], jcfg,
                                            "kinect")])
    out_j = jkp.build_keypoint_sets(
        jnp.asarray(rgb_s), jnp.asarray(rgb_t), jnp.asarray(feat_s),
        jnp.asarray(feat_t), key, jcfg, "kinect", jnp.asarray(gray_s),
        jnp.asarray(gray_t))
    out_t = tkp.build_keypoint_sets(
        t(rgb_s)[None], t(rgb_t)[None], t(feat_s)[None], t(feat_t)[None],
        tcfg, "kinect", gray_full_s=t(gray_s)[None],
        gray_full_t=t(gray_t)[None], draws=draws)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
    assert out_t[0].shape[1] == tcfg.capacity == 32 + 2 * 16 + 2 * 8
    assert bool((out_t[2] == 0.99).any()) and bool((out_t[2] == 1.0).any())

    geo = [ds["depth"], dt["depth"], ds["norm"], dt["norm"]]
    pj = jprim.extract_primitives(
        jnp.asarray(rgb_s), jnp.asarray(rgb_t), *map(jnp.asarray, geo),
        jnp.asarray(feat_s), jnp.asarray(feat_t), key, jcfg, "scannet",
        "kinect", gray_full_s=jnp.asarray(gray_s),
        gray_full_t=jnp.asarray(gray_t))
    pt_ = tprim.extract_primitives(
        t(rgb_s)[None], t(rgb_t)[None], *[t(g).float()[None] for g in geo],
        t(feat_s)[None], t(feat_t)[None], tcfg, "scannet", "kinect",
        gray_full_s=t(gray_s)[None], gray_full_t=t(gray_t)[None],
        draws=draws)
    for dj, dtt in zip(pj, pt_):
        for k in dj:
            np.testing.assert_allclose(np.asarray(dj[k]), dtt[k][0].numpy(),
                                       atol=1e-5, err_msg=k)
    assert jconfig.FACE_ORDER["scannet"] == config.FACE_ORDER["scannet"] \
        == config.FACE_ORDER["matterport"]
