"""core/quaternion.py of relativepose_tpu_torch against relativepose_tpu,
on the CPU: every function on the same random numpy inputs, to 1e-6
(f32 elementwise arithmetic; the trigonometric functions of the two
libraries differ by an ulp or two)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from relativepose_tpu.core import quaternion as jq
from relativepose_tpu_torch.core import quaternion as tq
from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-6


def both(fn, *args, **kw):
    """fn of both packages on the same numpy arguments -> numpy pair."""
    yj = getattr(jq, fn)(*map(jnp.asarray, args), **kw)
    yt = getattr(tq, fn)(*map(torch.from_numpy, args), **kw)
    return np.asarray(yj), yt.numpy()


def quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("fn", ["qconj", "qnormalize", "quaternion_to_rot"])
def test_unary(rng, fn):
    yj, yt = both(fn, quats(rng, 64) * 1.5)
    np.testing.assert_allclose(yj, yt, atol=TOL)


def test_qmul_and_qrot(rng):
    q, r = quats(rng, 64), quats(rng, 64)
    np.testing.assert_allclose(*both("qmul", q, r), atol=TOL)
    v = rng.randn(64, 3).astype(np.float32)
    np.testing.assert_allclose(*both("qrot", q, v), atol=5 * TOL)


def test_rot_to_quaternion_all_pivots(rng):
    """Each of the four pivot branches is taken (the largest of 1 + tr,
    1 + m00 - m11 - m22, ...), and w >= 0."""
    R = ScipyRot.random(64, random_state=rng).as_matrix()
    # rotations by ~pi about x, y and z pick the x, y and z pivots
    R = np.concatenate([R, np.stack([
        ScipyRot.from_rotvec(3.1 * np.eye(3)[i]).as_matrix()
        for i in range(3)]), np.eye(3)[None]]).astype(np.float32)
    m = R
    pivots = np.stack([1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2],
                       1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                       1 + m[:, 1, 1] - m[:, 0, 0] - m[:, 2, 2],
                       1 + m[:, 2, 2] - m[:, 0, 0] - m[:, 1, 1]], -1)
    assert set(np.argmax(pivots, -1)) == {0, 1, 2, 3}
    yj, yt = both("rot_to_quaternion", R)
    np.testing.assert_allclose(yj, yt, atol=TOL)
    assert (yt[:, 0] >= 0).all()


def test_expmap_to_quaternion(rng):
    e = np.concatenate([rng.randn(63, 3), np.zeros((1, 3))]).astype(
        np.float32)
    np.testing.assert_allclose(*both("expmap_to_quaternion", e), atol=TOL)


@pytest.mark.parametrize("order", ["zyx", "xyz"])
def test_euler(rng, order):
    e = (rng.rand(64, 3) * 2 - 1).astype(np.float32)
    np.testing.assert_allclose(*both("euler_to_quaternion", e, order=order),
                               atol=TOL)
    np.testing.assert_allclose(*both("qeuler", quats(rng, 64), order=order),
                               atol=TOL)


def test_unsupported_euler_order(rng):
    with pytest.raises(ValueError):
        tq.qeuler(torch.from_numpy(quats(rng, 2)), "yxz")


def test_qfix_sign_continuity(rng):
    """A sequence with random sign flips: the fixed sequence is the JAX
    package's and every consecutive dot product is non-negative."""
    base = np.cumsum(0.05 * rng.randn(50, 3, 4), axis=0) + quats(rng, 3)
    q = (base / np.linalg.norm(base, axis=-1, keepdims=True)).astype(
        np.float32)
    q = q * np.where(rng.rand(50, 3, 1) < 0.3, -1.0, 1.0).astype(np.float32)
    yj, yt = both("qfix", q)
    np.testing.assert_allclose(yj, yt, atol=0)
    assert (np.sum(yt[1:] * yt[:-1], -1) >= 0).all()
