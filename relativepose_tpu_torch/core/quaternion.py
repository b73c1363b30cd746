"""Quaternion algebra, batched over leading dimensions.

Port of `relativepose_tpu/core/quaternion.py`: conjugate, Hamilton
product, rotation of vectors, the rotation <-> quaternion converters, the
exponential map, Euler angles and sign continuity.  Quaternions are
(w, x, y, z) with w the scalar part.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def qconj(q):
    """Conjugate. q: [..., 4]."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qmul(q, r):
    """Hamilton product q*r. q, r: [..., 4] -> [..., 4]."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        dim=-1,
    )


def qrot(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4]."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qnormalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quaternion_to_rot(q):
    """Quaternion [..., 4] -> rotation matrix [..., 3, 3] (unit q assumed)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            w * w + x * x - y * y - z * z,
            2.0 * (x * y - w * z),
            2.0 * (w * y + x * z),
            2.0 * (x * y + w * z),
            w * w - x * x + y * y - z * z,
            2.0 * (y * z - w * x),
            2.0 * (x * z - w * y),
            2.0 * (w * x + y * z),
            w * w - x * x - y * y + z * z,
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def rot_to_quaternion(R):
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] with w >= 0.

    All four pivot candidates are built and the one with the largest
    pivot is taken (first on ties, as argmax does in both packages)."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    qw = [1.0 + tr, m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]]
    qx = [m[2][1] - m[1][2], 1.0 + m[0][0] - m[1][1] - m[2][2],
          m[0][1] + m[1][0], m[0][2] + m[2][0]]
    qy = [m[0][2] - m[2][0], m[0][1] + m[1][0],
          1.0 + m[1][1] - m[0][0] - m[2][2], m[1][2] + m[2][1]]
    qz = [m[1][0] - m[0][1], m[0][2] + m[2][0], m[1][2] + m[2][1],
          1.0 + m[2][2] - m[0][0] - m[1][1]]
    cands = torch.stack([torch.stack(c, dim=-1) for c in (qw, qx, qy, qz)],
                        dim=-2)
    pivots = torch.stack([qw[0], qx[1], qy[2], qz[3]], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    q = torch.take_along_dim(
        cands, best[..., None, None].expand(best.shape + (1, 4)),
        dim=-2)[..., 0, :]
    q = qnormalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def expmap_to_quaternion(e):
    """Axis-angle exponential map [..., 3] -> quaternion [..., 4]."""
    theta = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    half = 0.5 * theta
    s = torch.where(theta > _EPS,
                    torch.sin(half) / torch.clamp(theta, min=_EPS), 0.5)
    return torch.cat([torch.cos(half), s * e], dim=-1)


_AXES = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}


def euler_to_quaternion(e, order: str = "zyx"):
    """Euler angles [..., 3] (radians, per axis in `order`) -> quaternion."""
    q = None
    for i, ax in enumerate(order):
        half = 0.5 * e[..., i:i + 1]
        axis = torch.tensor(_AXES[ax], dtype=e.dtype, device=e.device)
        qi = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
        q = qi if q is None else qmul(q, qi)
    return q


def qeuler(q, order: str = "zyx"):
    """Quaternion [..., 4] -> Euler angles (radians) in the per-axis order
    of `order` ('xyz' or 'zyx'), so that `euler_to_quaternion(qeuler(q,
    o), o)` round-trips."""
    w, x, y, z = q.unbind(-1)
    if order == "xyz":
        ex = torch.atan2(2.0 * (x * w - y * z), 1.0 - 2.0 * (x * x + y * y))
        ey = torch.asin(torch.clamp(2.0 * (x * z + y * w), -1.0, 1.0))
        ez = torch.atan2(2.0 * (z * w - x * y), 1.0 - 2.0 * (y * y + z * z))
        return torch.stack([ex, ey, ez], dim=-1)
    if order == "zyx":
        ex = torch.atan2(2.0 * (x * w + y * z), 1.0 - 2.0 * (x * x + y * y))
        ey = torch.asin(torch.clamp(2.0 * (y * w - x * z), -1.0, 1.0))
        ez = torch.atan2(2.0 * (z * w + x * y), 1.0 - 2.0 * (y * y + z * z))
        return torch.stack([ez, ey, ex], dim=-1)
    raise ValueError(f"unsupported euler order {order!r}")


def qfix(q):
    """Sign continuity along the first (time) axis, q: [T, ..., 4]: each
    quaternion is flipped so that consecutive ones have a non-negative dot
    product."""
    dots = torch.sum(q[1:] * q[:-1], dim=-1)
    flips = torch.cumprod(torch.where(dots < 0, -1.0, 1.0), dim=0)
    return torch.cat([q[:1], q[1:] * flips[..., None].to(q.dtype)], dim=0)
