"""Rotation helpers: elementary rotations, rigid transforms and geodesic
distance.

Port of `relativepose_tpu/core/rotation.py` (rx, ry, rz, make_se3,
inverse_se3, angular_distance, axis_angle_to_rot, random_rotation),
batched over leading dimensions.  The random draws of `random_rotation`
are passed in as tensors, so a test can hand it the JAX package's draws.

Products of small matrices go through `small_matmul`, which rounds as
XLA's CPU dot does (a fused multiply-add chain over the inner dimension)
on every device; torch's own small batched products round each product
separately.
"""

from __future__ import annotations

import math

import torch


def _fma_chain(terms_a, terms_b, dtype):
    acc = terms_a[0] * terms_b[0]
    for ai, bi in zip(terms_a[1:], terms_b[1:]):
        acc = (ai.double() * bi.double() + acc.double()).to(dtype)
    return acc


def fma_dot(a, b):
    """sum(a * b, -1) in f32 as a fused multiply-add chain over the last
    axis (how XLA's CPU backend reduces a short product inside a fused
    program); see `small_matmul`."""
    return _fma_chain(a.unbind(-1), b.unbind(-1), a.dtype)


def small_matmul(a, b):
    """a [..., m, k] @ b [..., k, n] in f32 as a fused multiply-add chain
    over k: acc = a0 b0, then acc = fma(a_i, b_i, acc).  The fma is exact
    products and one rounding, emulated in f64 (an f32 product is exact in
    f64)."""
    return _fma_chain([t[..., :, None] for t in a.unbind(-1)],
                      [t[..., None, :] for t in b.unbind(-2)], a.dtype)


def _elementary(angle, entries):
    angle = torch.as_tensor(angle)
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    parts = {"c": c, "s": s, "-s": -s, "0": z, "1": o}
    return torch.stack([parts[e] for e in entries.split()], dim=-1) \
        .reshape(angle.shape + (3, 3))


def rx(theta):
    """Rotation about x by `theta` (radians): [...] -> [..., 3, 3]."""
    return _elementary(theta, "1 0 0  0 c -s  0 s c")


def ry(phi):
    """Rotation about y by `phi` (radians): [...] -> [..., 3, 3]."""
    return _elementary(phi, "c 0 s  0 1 0  -s 0 c")


def rz(psi):
    """Rotation about z by `psi` (radians): [...] -> [..., 3, 3]."""
    return _elementary(psi, "c -s 0  s c 0  0 0 1")


def angular_distance(R_hat, R):
    """Geodesic distance in degrees between rotations [..., 3, 3]."""
    rel = R_hat @ R.transpose(-1, -2)
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    return torch.rad2deg(
        torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)))


def make_se3(R, t):
    """Assemble [..., 4, 4] rigid transforms from R [..., 3, 3], t [..., 3]."""
    T = R.new_zeros(R.shape[:-2] + (4, 4))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def inverse_se3(T):
    """Invert a rigid [..., 4, 4] transform."""
    Rinv = T[..., :3, :3].transpose(-1, -2)
    tinv = -small_matmul(Rinv, T[..., :3, 3, None])[..., 0]
    return make_se3(Rinv, tinv)


def axis_angle_to_rot(axis, theta):
    """Rodrigues formula. axis: [..., 3] (unit), theta: [...]."""
    ax, ay, az = axis.unbind(-1)
    zeros = torch.zeros_like(ax)
    K = torch.stack([zeros, -az, ay, az, zeros, -ax, -ay, ax, zeros],
                    dim=-1).reshape(ax.shape + (3, 3))
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return eye + s * K + (1.0 - c) * small_matmul(K, K)


def random_rotation(axis_u, angle_n, epsilon: float):
    """Random small rotation (the JAX package's `random_rotation`).

    axis_u: [..., 3] uniforms in [0, 1) (the axis is axis_u - 0.5,
    normalised); angle_n: [...] standard normals (the angle is
    angle_n * pi * epsilon).  Returns [..., 3, 3]."""
    axis = axis_u - 0.5
    norm = torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    axis = axis / torch.clamp(norm, min=1e-12)
    return axis_angle_to_rot(axis, angle_n * math.pi * epsilon)
