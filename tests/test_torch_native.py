"""The port's native registration library against the JAX package's.

The port builds `cpp/registration.cpp` itself with g++ (the flags of
`cpp/Makefile`) into `relativepose_tpu_torch/build/`; the JAX package
loads the tracked `cpp/librpregistration.so`.  Both are -march=native
builds of one source, so they could contract floating-point operations
differently and round apart in the last bits; on the box scene and the
pano clouds of `tests/test_native.py` they agree bit for bit, and these
tests hold them to that: every function, the RANSAC methods included
(their seeds are fixed).  super4pcs is the exception: its search stops at
a wall-clock budget, so how far it gets depends on the machine's load;
the port's is held to the JAX test's bound against the truth instead."""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as SR

from relativepose_tpu.native import registration as jreg
from relativepose_tpu_torch.native import registration as treg
from test_native import box_cloud, rot_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    pts = box_cloud(rng)
    R = SR.from_euler("zyx", [25, 10, -15], degrees=True).as_matrix()
    t = np.array([0.3, -0.2, 0.5])
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return pts, pts @ R.T + t, T


@pytest.fixture(scope="module")
def pano():
    """The observed-face clouds of synthetic suncg pair 31 (the pano
    fixture of tests/test_native.py), through the port's parse."""
    import torch

    from relativepose_tpu_torch.data import synthetic
    from relativepose_tpu_torch.eval import harness

    ds, dt, T_gt = synthetic.make_pair(31, "suncg", max_baseline=0.35)
    out = []
    for d in (ds, dt):
        pc, val, col = harness.parse_eval_data(
            *(torch.as_tensor(np.asarray(d[k]))[None]
              for k in ("depth", "rgb", "norm")), "suncg", "gs")
        v = val[0].numpy()
        out += [pc[0].numpy()[v], col[0].numpy()[v]]
    ps, cs, pt, ct = out
    return ps, pt, cs, ct, np.asarray(T_gt)


def test_builds_into_the_port():
    path = treg.build()
    assert path.parent == treg.BUILD_DIR and path.exists()
    assert path.name.startswith("librpregistration-")


def test_parallel_first_use_builds_one_whole_library(tmp_path):
    """Three processes build into an empty directory at once: each loads a
    whole library, none maps the tracked cpp/librpregistration.so, and no
    temporary file is left behind."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from relativepose_tpu_torch.native import registration as r\n"
        "r.BUILD_DIR = Path(sys.argv[1])\n"
        "import numpy as np\n"
        "n = len(r.voxel_downsample(np.random.RandomState(0).rand(500, 3),"
        " 0.2))\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(r.lib_path()) in maps\n"
        "assert 'cpp/librpregistration.so' not in maps\n"
        "print(n)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert len({o.strip() for o, _ in outs}) == 1
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 1 and files[0].endswith(".so"), files


@pytest.mark.parametrize("fn, args", [
    ("voxel_downsample", (0.2,)),
    ("estimate_normals", (0.3,)),
    ("fpfh", (0.2, 0.4)),
])
def test_features_equal_jax(scene, pano, fn, args):
    for pts in (scene[0][:800], pano[0]):
        a = getattr(jreg, fn)(pts, *args)
        b = getattr(treg, fn)(pts, *args)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_overlap_stats_equal_jax(scene, pano):
    for s, t, T in ((scene[0], scene[1], scene[2]),
                    (pano[0], pano[1], pano[4])):
        assert jreg.overlap_stats(s, t, T) == treg.overlap_stats(s, t, T)


@pytest.mark.parametrize("method", ["gs", "fgs", "cgs", "icp"])
def test_seeded_registrations_equal_jax(scene, pano, method):
    pts, tgt, T = scene
    ps, pt, cs, ct, T_gt = pano
    cols = np.abs(pts) / np.abs(pts).max()
    T0 = T.copy()
    T0[:3, :3] = SR.from_euler("z", 4, degrees=True).as_matrix() @ T[:3, :3]
    T0[:3, 3] += [0.03, -0.02, 0.01]
    calls = {
        "gs": [("global_registration", (pts, tgt, 0.1, 20000), {}),
               ("global_registration", (ps, pt), {})],
        "fgs": [("fast_global_registration", (pts, tgt, 0.1), {}),
                ("fast_global_registration", (ps, pt), {})],
        "cgs": [("colored_registration",
                 (pts[::3], tgt[::3], cols[::3], cols[::3], 0.1), {}),
                ("colored_registration", (ps, pt, cs, ct), {})],
        "icp": [("icp_point_to_plane", (pts, tgt),
                 dict(voxel=0.05, max_dist=0.15, iters=30, init=T0))],
    }[method]
    for name, a, kw in calls:
        Tj = getattr(jreg, name)(*a, **kw)
        Tt = getattr(treg, name)(*a, **kw)
        np.testing.assert_array_equal(Tt, Tj, err_msg=name)
    # the box scene is recovered, as tests/test_native.py requires
    Tt = getattr(treg, calls[0][0])(*calls[0][1], **calls[0][2])
    assert rot_err(Tt, T[:3, :3]) < {"gs": 5.0, "fgs": 10.0, "cgs": 30.0,
                                     "icp": 1.5}[method]


def test_super4pcs_recovers_the_box(scene):
    pts, tgt, T = scene
    Tt = treg.super4pcs(pts, tgt, time_budget_s=5.0, delta=0.08)
    assert np.isfinite(Tt).all()
    assert rot_err(Tt, T[:3, :3]) < 8.0
