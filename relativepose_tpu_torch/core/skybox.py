"""Skybox (4-face cubemap strip) camera model, batched.

Port of `relativepose_tpu/core/skybox.py` (`face_rotations`,
`pano_to_pointcloud`, `face_depth_to_pointcloud`, the kinect lifts,
`pano_idx`, `splat_to_pano`, `lift_keypoints`).  Each view is a 160x640 panorama of
four 160x160 pinhole faces with 90-degree FOV: face pixel (x, y) maps to
NDC xs = (x/F - 0.5)*2, ys = (0.5 - y/F)*2 and depth z > 0 lifts to the
camera point (xs*z, ys*z, -z).  Pano column block j looks through
`FACE_ROTATIONS[FACE_ORDER[dataset][j]]`.  Every function works on
leading batch dimensions and returns fixed shapes plus validity masks.
ScanNet shares matterport's face order; its lifts divide the NDC by the
kinect intrinsics factors `KINECT_FX_DIV` / `KINECT_FY_DIV`.

No division here is by a Python number: CUDA computes one as a product
with the number's rounded f32 reciprocal and the CPU as a true quotient,
which differ by one ulp for some inputs.  Divisors are tensors
(`_divisor`), except that `pano_to_pointcloud`'s scannet lift multiplies
by the f32 reciprocals of the kinect factors on every device: that is
what the JAX package's compiled (jit) programs compute for a division by
a constant, and the training data pipeline matches them bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from relativepose_tpu_torch import config

FACE = config.FACE


def face_rotations(dataset: str, dtype=torch.float32, device="cuda"):
    """[4, 3, 3] rotation for each pano column block of `dataset`."""
    order = config.FACE_ORDER[config.canonical_dataset(dataset)]
    return torch.as_tensor(config.FACE_ROTATIONS[list(order)], dtype=dtype,
                           device=device)


def _face_ndc(h: int = FACE, w: int = FACE):
    """Per-pixel NDC grids (xs, ys) for an h x w face, numpy constants."""
    ys, xs = np.meshgrid(range(h), range(w), indexing="ij")
    ys = (0.5 - ys / h) * 2.0
    xs = (xs / w - 0.5) * 2.0
    return xs.astype(np.float32), ys.astype(np.float32)


def _divisor(value: float, like):
    """`value` as a 0-d tensor of like's dtype and device, so that x / it is
    a true division on every device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _reciprocal(value: float) -> float:
    """The f32 reciprocal of `value` (a product with an f32 value is exact
    on every device)."""
    return float(np.float32(1.0) / np.float32(value))


def _ndc_flat(device, h: int = FACE, w: int = FACE):
    xs, ys = _face_ndc(h, w)
    return (torch.from_numpy(xs.reshape(-1)).to(device),
            torch.from_numpy(ys.reshape(-1)).to(device))


def pano_to_pointcloud(depth, dataset: str):
    """Lift a full pano depth map to camera-0 points.

    depth: [..., FACE, 4*FACE] -> (points [..., 4*FACE*FACE, 3],
    valid [..., 4*FACE*FACE]), face-major and row-major within a face.
    """
    ds = config.canonical_dataset(dataset)
    rots = face_rotations(ds, depth.dtype, depth.device)
    xs, ys = _ndc_flat(depth.device)
    pcs, valids = [], []
    for j, face in enumerate(torch.split(depth, FACE, dim=-1)):
        z = face.reshape(depth.shape[:-2] + (-1,))
        if ds == "scannet":
            x = xs * z * _reciprocal(config.KINECT_FX_DIV)
            y = ys * z * _reciprocal(config.KINECT_FY_DIV)
        else:
            x, y = xs * z, ys * z
        cam = torch.stack([x, y, -z], dim=-1)
        pcs.append(cam @ rots[j].T)
        valids.append(z != 0)
    return torch.cat(pcs, dim=-2), torch.cat(valids, dim=-1)


def face_depth_to_pointcloud(depth, dataset: str, second_face=None):
    """Lift a single 160x160 face depth map (the observed face).

    For suncg the points are rotated by FACE_ROTATIONS[1] (the observed
    face is the second one).  depth: [..., FACE, FACE] ->
    (points [..., FACE*FACE, 3], valid).
    """
    ds = config.canonical_dataset(dataset)
    if second_face is None:
        second_face = ds == "suncg"
    xs, ys = _ndc_flat(depth.device)
    z = depth.reshape(depth.shape[:-2] + (-1,))
    pc = torch.stack([xs * z, ys * z, -z], dim=-1)
    if second_face:
        R1 = torch.as_tensor(config.FACE_ROTATIONS[1], dtype=depth.dtype,
                             device=depth.device)
        pc = pc @ R1.T
    return pc, z != 0


def kinect_crop_to_pointcloud(depth):
    """Lift the 66x88 kinect crop.

    depth: [..., 66, 88] -> (points [..., 66*88, 3], valid)."""
    h, w = config.KINECT_FOV_H, config.KINECT_FOV_W
    xs, ys = _ndc_flat(depth.device, h, w)
    z = depth.reshape(depth.shape[:-2] + (-1,))
    pc = torch.stack(
        [xs * z * (w / 160.0), ys * z * (h / 160.0), -z], dim=-1)
    return pc, z != 0


def kinect_full_to_pointcloud(depth):
    """Lift a full-size 480x640 kinect depth map.

    depth: [..., 480, 640] -> (points [..., 480*640, 3], valid)."""
    h, w = config.KINECT_FULL_H, config.KINECT_FULL_W
    xs, ys = _ndc_flat(depth.device, h, w)
    z = depth.reshape(depth.shape[:-2] + (-1,))
    pc = torch.stack(
        [xs * z / _divisor(config.KINECT_FX_DIV, z),
         ys * z / _divisor(config.KINECT_FY_DIV, z), -z], dim=-1)
    return pc, z != 0


def pano_idx(flat_index, h: int = FACE, w: int = 4 * FACE):
    """Flat point-cloud index [...] (the order of `pano_to_pointcloud`) ->
    (x, y) pano pixel coordinates [..., 2]."""
    single = (h * w) // 4
    face = flat_index // single
    rest = flat_index % single
    return torch.stack([rest % h + face * h, rest // h], dim=-1)


def _rot_component(R, i, comps):
    """Component i of R^T p for a signed-permutation numpy constant R.

    The 0/+-1 coefficients are folded here, so the rotation is component
    shuffles and exact (as in the JAX package)."""
    out = None
    for j in range(3):
        c = float(R[j, i])
        if c == 0.0:
            continue
        term = comps[j] if c == 1.0 else (
            -comps[j] if c == -1.0 else c * comps[j])
        out = term if out is None else out + term
    return out if out is not None else torch.zeros_like(comps[0])


def project_to_faces(points, valid, dataset: str):
    """Nearest pano pixel of each point, by the face that sees it.

    points: [..., N, 3]; valid: [..., N] bool.  Returns (v, u, ok, lz):
    integer row and column [..., N] (the column includes the face block's
    offset), whether some face sees the point, and its face-frame z.  Of
    the faces that see a point the first in pano order wins; where ok is
    False, v and u mean nothing.  The splat and the ICP association both
    project through it, as both do in the JAX package.
    """
    ds = config.canonical_dataset(dataset)
    order = config.FACE_ORDER[ds]
    H = FACE
    comps = points.unbind(-1)
    any_ok = torch.zeros_like(valid)
    block = torch.zeros(valid.shape, dtype=torch.int64, device=valid.device)
    zero = torch.zeros_like(comps[0])
    lxs, lys, lzs = zero, zero, zero
    for f in range(4):
        R = config.FACE_ROTATIONS[order[f]]
        lx = _rot_component(R, 0, comps)
        ly = _rot_component(R, 1, comps)
        lz = _rot_component(R, 2, comps)
        lim = 1e-32 - lz  # == |l_z| + 1e-32 when l_z < 0 (the only ok case)
        ok = valid & (lz < 0) & (lx.abs() < lim) & (ly.abs() < lim)
        take = ok & ~any_ok  # the first face that sees a point wins
        block = torch.where(take, f, block)
        lxs = torch.where(take, lx, lxs)
        lys = torch.where(take, ly, lys)
        lzs = torch.where(take, lz, lzs)
        any_ok = any_ok | ok
    denom = lzs.abs() + 1e-32
    xs = lxs / denom
    ys = lys / denom
    # torch.round, like jnp.round, rounds half to even
    u = torch.clamp(torch.round((xs + 1.0) * 0.5 * H), 0, H - 1).long()
    v = torch.clamp(torch.round((1.0 - ys) * 0.5 * H), 0, H - 1).long()
    return v, u + block * H, any_ok, lzs


def splat_to_pano(points, values, valid, dataset: str, num_channels: int):
    """Forward-splat points onto the 4-face pano (nearest pixel).

    points: [..., N, 3]; values: [..., N, C]; valid: [..., N] bool.
    Returns (pano [..., FACE, 4*FACE, C], depth [..., FACE, 4*FACE]), where
    depth is the splatted -z.  Of the points that land on one pixel the
    highest point index wins: a scatter-max of the index into an int
    buffer filled with -1, with a trash slot at M for points that land
    nowhere — the same winners as the JAX package.
    """
    H = FACE
    batch = points.shape[:-2]
    n = points.shape[-2]
    v, u, any_ok, lzs = project_to_faces(points, valid, dataset)

    M = H * 4 * H
    flat = torch.where(any_ok, v * (4 * H) + u, M).reshape(-1, n)
    payload = torch.cat([values, -lzs[..., None]], dim=-1)
    pos = torch.arange(n, device=points.device).expand(flat.shape)
    idxbuf = torch.full((flat.shape[0], M + 1), -1, dtype=torch.int64,
                        device=points.device)
    idxbuf = idxbuf.scatter_reduce(1, flat, pos, "amax", include_self=True)
    idxbuf = idxbuf[:, :M]
    hit = idxbuf >= 0
    sel = idxbuf.clamp(min=0)
    payload = payload.reshape(-1, n, payload.shape[-1])
    rows = torch.gather(payload, 1, sel[..., None].expand(
        sel.shape + (payload.shape[-1],)))
    rows = torch.where(hit[..., None], rows, 0.0)
    pano = rows[..., :num_channels].reshape(batch + (H, 4 * H, num_channels))
    depth = rows[..., num_channels].reshape(batch + (H, 4 * H))
    return pano, depth


def gather_pixels(img, yi, xi):
    """img [B, H, W, C] at integer pixels (yi, xi) [B, N] -> [B, N, C]."""
    b, h, w, c = img.shape
    flat = (yi * w + xi).long()
    return torch.gather(img.reshape(b, h * w, c), 1,
                        flat[..., None].expand(flat.shape + (c,)))


def lift_keypoints(depth, normal, pts, dataset: str):
    """Bilinear depth/normal at subpixel pano keypoints + 3D lift.

    depth: [B, FACE, 4*FACE]; normal: [B, FACE, 4*FACE, 3]; pts: [B, N, 2]
    float (x, y) pano coords.  Returns (pc [B, N, 3], nrm [B, N, 3]).
    """
    ds = config.canonical_dataset(dataset)
    rots = face_rotations(ds, depth.dtype, depth.device)
    H = FACE
    x, y = pts[..., 0], pts[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    xi1 = torch.clamp(xi + 1, 0, 4 * H - 1)
    yi1 = torch.clamp(yi + 1, 0, H - 1)
    xi = torch.clamp(xi, 0, 4 * H - 1)
    yi = torch.clamp(yi, 0, H - 1)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    def bilerp(img):
        return (
            gather_pixels(img, yi, xi) * (wy0 * wx0)[..., None]
            + gather_pixels(img, yi, xi1) * (wy0 * wx1)[..., None]
            + gather_pixels(img, yi1, xi) * (wy1 * wx0)[..., None]
            + gather_pixels(img, yi1, xi1) * (wy1 * wx1)[..., None]
        )

    val = bilerp(depth[..., None])[..., 0]
    nrm = bilerp(normal)
    nrm = nrm / torch.sqrt(torch.sum(nrm * nrm, dim=-1, keepdim=True) + 1e-24)

    h = _divisor(H, x)
    face = torch.floor_divide(x, h).to(torch.int64)
    xstp = ((x - face * H) / h - 0.5) * 2.0
    ystp = (0.5 - y / h) * 2.0
    cam = torch.stack([xstp * val, ystp * val, -val], dim=-1)
    pc = (rots[face] @ cam[..., None])[..., 0]
    return pc, nrm
