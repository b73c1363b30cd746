"""Plot helpers rendered to numpy images (utils/plot.py:14-241).

Used for tensorboard panels and eval artifacts: series plots, histograms,
cumulative-error curves, and a matplotlib-figure -> HWC-uint8 converter.
Matplotlib runs headless (Agg).

A copy of `relativepose_tpu/utils/plot.py`.  Matplotlib is imported
inside the functions (`_pyplot`), so importing this module needs none;
`plot_keypoint_sets` aligns with the port's `core/horn.py`.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plt2npy(fig) -> np.ndarray:
    """Render a matplotlib figure to an RGB uint8 array (plot.py:225-232)."""
    plt = _pyplot()
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    img = buf.reshape(h, w, 4)[..., :3].copy()
    plt.close(fig)
    return img


def plot_series(series, labels=None, title="", xlabel="", ylabel=""):
    """Line plot(s) -> image (plot.py:14-37)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
    series = np.atleast_2d(np.asarray(series, dtype=float))
    for i, s in enumerate(series):
        ax.plot(s, label=labels[i] if labels else None)
    if labels:
        ax.legend()
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    return plt2npy(fig)


def plot_histogram(values, bins=50, title="", xlabel=""):
    """Histogram -> image (plot.py:39-59)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
    ax.hist(np.asarray(values, dtype=float).ravel(), bins=bins)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.grid(True, alpha=0.3)
    return plt2npy(fig)


def plot_cumulative(values_list, labels=None, title="", xlabel="error",
                    x_max=None):
    """Cumulative-error curve(s) -> image (plot.py:61-84) — the reference's
    per-epoch normal-angle / depth-L1 / descriptor-ratio eval artifact."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
    if not isinstance(values_list, (list, tuple)):
        values_list = [values_list]
    for i, vals in enumerate(values_list):
        v = np.sort(np.asarray(vals, dtype=float).ravel())
        if len(v) == 0:
            continue
        y = np.arange(1, len(v) + 1) / len(v)
        ax.plot(v, y, label=labels[i] if labels else None)
    if labels:
        ax.legend()
    if x_max is not None:
        ax.set_xlim(0, x_max)
    ax.set_ylim(0, 1)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("fraction")
    ax.grid(True, alpha=0.3)
    return plt2npy(fig)


def plot_keypoints_3d(points, title=""):
    """Simple 3-D scatter of keypoints/voxels -> image (plot.py:87-223)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(5, 5), dpi=100)
    ax = fig.add_subplot(projection="3d")
    p = np.asarray(points, dtype=float).reshape(-1, 3)
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=2)
    ax.set_title(title)
    return plt2npy(fig)


def plot_voxels(vox, threshold=0.5, mode="fix_size", title=""):
    """Occupancy-grid scatter -> image (plot.py:87-123 vox_to_image).

    vox: [D, D, D] (a trailing singleton channel is squeezed).  In
    'fix_size' mode cells with value > threshold are drawn at a constant
    size; in 'weighted' mode every positive cell is drawn with size
    proportional to its value (the reference's non-fix_size branch,
    with its y/z axis flips).
    """
    plt = _pyplot()
    vox = np.asarray(vox, dtype=float)
    vox = vox.reshape(vox.shape[0], vox.shape[1], vox.shape[2])
    dim = vox.shape[0]
    fig = plt.figure(figsize=(5, 5), dpi=100)
    ax = fig.add_subplot(projection="3d")
    for axis in (ax.set_xlim, ax.set_ylim, ax.set_zlim):
        axis(0, dim)
    if mode == "fix_size":
        zs, ys, xs = np.where(vox > threshold)
        ax.scatter(xs, ys, zs, s=10)
    else:
        xs, ys, zs = np.where(vox > 0)
        sizes = vox[xs, ys, zs]
        ax.scatter(xs, dim - 1 - ys, dim - 1 - zs, s=sizes)
    ax.set_xlabel("X axis")
    ax.set_ylabel("Y axis")
    ax.set_zlabel("Z axis")
    ax.set_title(title)
    return plt2npy(fig)


def _scatter_skeleton(ax, pts, edges):
    """One keypoint set [3, J] with optional edge segments; endpoints at
    (-1,-1,-1) mark invalid joints (plot.py:153-170 show3D)."""
    ax.scatter(pts[0], pts[1], pts[2])
    for e in edges or ():
        seg = pts[:, list(e)]
        if np.any(np.all(seg == -1.0, axis=0)):
            continue
        ax.plot(seg[0], seg[1], seg[2])


def plot_keypoint_sets(keypoints, edges=None, align=False, title=""):
    """N keypoint sets [N, 3, J] -> image (plot.py:172-196
    visualize_keypoint).  With align=True every set is rigidly aligned to
    set 0 (Horn'87 on the matched joints) before drawing, so the panel
    shows shape agreement independent of pose.
    """
    plt = _pyplot()
    kp = np.asarray(keypoints, dtype=float)
    fig = plt.figure(figsize=(5, 5), dpi=100)
    ax = fig.add_subplot(projection="3d")
    if align and kp.shape[0] > 1:
        import torch

        from relativepose_tpu_torch.core.horn import horn87
        ref = kp[0]
        ref_c = ref - ref.mean(1, keepdims=True)
        for i in range(kp.shape[0]):
            cur = kp[i]
            cur_c = cur - cur.mean(1, keepdims=True)
            R = horn87(torch.as_tensor(cur_c.T, dtype=torch.float32),
                       torch.as_tensor(ref_c.T, dtype=torch.float32)).numpy()
            aligned = R @ cur_c + ref.mean(1, keepdims=True)
            _scatter_skeleton(ax, aligned, edges)
    else:
        for i in range(kp.shape[0]):
            _scatter_skeleton(ax, kp[i], edges)
    ax.set_title(title)
    return plt2npy(fig)


def plot_contour(levelset, n_levels=20, title=""):
    """Iso-contour plot of a 2-D level-set / heatmap -> image
    (plot.py:234-241 PlotContour), with colorbar, axes off."""
    plt = _pyplot()
    ls = np.asarray(levelset, dtype=float)
    fig, ax = plt.subplots(figsize=(5, 5), dpi=100)
    ax.axis("off")
    ys, xs = np.meshgrid(range(ls.shape[0]), range(ls.shape[1]),
                         indexing="ij")
    cs = ax.contour(xs, ys, ls, n_levels)
    fig.colorbar(cs, ax=ax)
    ax.set_title(title)
    return plt2npy(fig)
