"""ctypes bindings for the native registration library, built by the port.

Counterpart of `relativepose_tpu/native/registration.py`, with the same
functions and the same numpy-in, numpy-out contract: every registration
returns a 4x4 transform mapping source points into the target frame.

The library is built from `cpp/registration.cpp` with `g++` at first use,
with the flags of `cpp/Makefile`, into `relativepose_tpu_torch/build/`
(`native/build.py`: the name hashes the source, the flags and the
processor).  The `cpp/librpregistration.so` in the repository is never
loaded here: it is bound to the processor it was built on.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from relativepose_tpu_torch.native import build as native_build

SOURCE = native_build.PKG.parent / "cpp" / "registration.cpp"
BUILD_DIR = native_build.BUILD_DIR
CXXFLAGS = native_build.CXXFLAGS

_LIB = None
build_seconds = None   # seconds of this process's build, None if none ran


def lib_path() -> Path:
    return native_build.lib_path(SOURCE, "rpregistration", CXXFLAGS,
                                 BUILD_DIR)


def build() -> Path:
    """Build the library unless it is built; returns its path."""
    global build_seconds
    out, seconds = native_build.build(SOURCE, "rpregistration", CXXFLAGS,
                                      BUILD_DIR)
    if seconds is not None:
        build_seconds = seconds
    return out


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    D = ctypes.POINTER(ctypes.c_double)
    F = ctypes.POINTER(ctypes.c_float)
    i, d, u64 = ctypes.c_int, ctypes.c_double, ctypes.c_uint64
    lib.rp_global_registration.argtypes = [D, i, D, i, d, i, u64, D]
    lib.rp_fast_global_registration.argtypes = [D, i, D, i, d, D]
    lib.rp_colored_registration.argtypes = [D, D, i, D, D, i, d, u64, D]
    lib.rp_super4pcs.argtypes = [D, i, D, i, d, d, d, i, u64, D]
    lib.rp_icp_point_to_plane.argtypes = [D, i, D, i, d, d, i, D, D]
    lib.rp_voxel_downsample.argtypes = [D, i, d, D, i]
    lib.rp_voxel_downsample.restype = i
    lib.rp_estimate_normals.argtypes = [D, i, d, D]
    lib.rp_fpfh.argtypes = [D, i, d, d, F]
    lib.rp_overlap_stats.argtypes = [D, i, D, i, D, d, D]
    _LIB = lib
    return lib


def _cptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _prep(pc):
    a = np.ascontiguousarray(np.asarray(pc, np.float64).reshape(-1, 3))
    return a, len(a)


def global_registration(pc_src, pc_tgt, voxel=0.05, max_iters=40000,
                        seed=0):
    """FPFH features and RANSAC."""
    lib = _load()
    s, ns = _prep(pc_src)
    t, nt = _prep(pc_tgt)
    out = np.eye(4)
    lib.rp_global_registration(_cptr(s), ns, _cptr(t), nt, voxel, max_iters,
                               seed, _cptr(out))
    return out


def fast_global_registration(pc_src, pc_tgt, voxel=0.05):
    """Geman-McClure optimisation over FPFH matches."""
    lib = _load()
    s, ns = _prep(pc_src)
    t, nt = _prep(pc_tgt)
    out = np.eye(4)
    lib.rp_fast_global_registration(_cptr(s), ns, _cptr(t), nt, voxel,
                                    _cptr(out))
    return out


def colored_registration(pc_src, pc_tgt, col_src, col_tgt, voxel=0.05,
                         seed=0):
    """RANSAC initialisation and multi-scale coloured ICP."""
    lib = _load()
    s, ns = _prep(pc_src)
    t, nt = _prep(pc_tgt)
    cs, _ = _prep(col_src)
    ct, _ = _prep(col_tgt)
    out = np.eye(4)
    lib.rp_colored_registration(_cptr(s), _cptr(cs), ns, _cptr(t), _cptr(ct),
                                nt, voxel, seed, _cptr(out))
    return out


def super4pcs(pc_src, pc_tgt, overlap=0.5, delta=0.1, time_budget_s=240.0,
              n_points=200, seed=0):
    """4PCS-style congruent-set search within `time_budget_s` seconds."""
    lib = _load()
    s, ns = _prep(pc_src)
    t, nt = _prep(pc_tgt)
    out = np.eye(4)
    lib.rp_super4pcs(_cptr(s), ns, _cptr(t), nt, overlap, delta,
                     time_budget_s, n_points, seed, _cptr(out))
    return out


def icp_point_to_plane(pc_src, pc_tgt, voxel=0.02, max_dist=0.05, iters=30,
                       init=None):
    lib = _load()
    s, ns = _prep(pc_src)
    t, nt = _prep(pc_tgt)
    out = np.eye(4)
    init_arr = np.ascontiguousarray(
        np.asarray(init if init is not None else np.eye(4), np.float64))
    lib.rp_icp_point_to_plane(_cptr(s), ns, _cptr(t), nt, voxel, max_dist,
                              iters, _cptr(init_arr), _cptr(out))
    return out


def voxel_downsample(pc, voxel):
    lib = _load()
    p, n = _prep(pc)
    out = np.zeros((n, 3))
    m = lib.rp_voxel_downsample(_cptr(p), n, voxel, _cptr(out), n)
    return out[: min(m, n)]


def estimate_normals(pc, radius):
    lib = _load()
    p, n = _prep(pc)
    out = np.zeros((n, 3))
    lib.rp_estimate_normals(_cptr(p), n, radius, _cptr(out))
    return out


def fpfh(pc, normal_radius=0.1, feat_radius=0.25):
    lib = _load()
    p, n = _prep(pc)
    out = np.zeros((n, 33), np.float32)
    lib.rp_fpfh(_cptr(p), n, normal_radius, feat_radius,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def overlap_stats(pc_src, pc_tgt, T_gt, thresh=0.08):
    """Overlap statistics (`core/overlap.py`'s semantics) through the
    library's grid hash: O(N) per scan, usable on the ~300k-point ScanNet
    frames where the chunked-matmul path is O(N^2)."""
    lib = _load()
    s, ns = _prep(pc_src)
    t, nt = _prep(pc_tgt)
    T = np.ascontiguousarray(np.asarray(T_gt, np.float64).reshape(4, 4))
    out = np.zeros(5)
    lib.rp_overlap_stats(_cptr(s), ns, _cptr(t), nt, _cptr(T), thresh,
                         _cptr(out))
    return {"overlap": out[0], "cam_dist": out[1], "pc_dist": out[2],
            "pc_nn": out[3]}
