"""The solver's two CUDA kernels, their plain PyTorch versions and their build.

The JAX package has two Pallas TPU kernels, both in
`relativepose_tpu/ops/pallas_kernels.py`; each is a hand-written CUDA
kernel here, with its source in `csrc/`:

  * `pair_weight_matrix` (csrc/pair_weight.cu) replaces
    `pair_weight_matrix_vmem` / `_wbuild_kernel`: the symmetric
    pair-consistency matrix W and the early-out counts.  Its plain version
    is `pair_weight_matrix_plain`, the port of
    `relativepose_tpu/match/solver.py::pair_weight_matrix`.
  * `power_iteration` (csrc/power_iteration.cu) replaces
    `power_iteration_vmem` / `_power_kernel`: the dominant eigenvector of
    W o (h (+) h).  Its plain version is `power_iteration_plain`, the f32
    loop of `power_iteration_vmem`'s non-TPU branch.

A wrapper takes its plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises; nothing falls back.  Each wrapper
counts its launches (`KERNELS[name].launches`).  The kernels have no
backward, as the Pallas kernels have no autodiff rule: a CUDA call whose
inputs or sigmas require grad while grad mode is on raises
(`check_no_grad`) instead of returning a result that silently drops the
gradient.  The plain versions stay differentiable.

Build: at first use, `nvcc` compiles each source into a shared library with
a plain C interface under `relativepose_tpu_torch/build/` (one process per
source, all started together), and `ctypes` loads it.  The library's name
carries a hash of its source and flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class CudaKernel:
    """One CUDA source built into its own shared library, and its count."""

    def __init__(self, name, source, symbol, argtypes, extra_flags=(),
                 replaces=""):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.replaces = replaces
        self.launches = 0
        self.lib = None
        self.build_seconds = None
        self.ptxas_info = ""

    def _lib_path(self):
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(self.flags).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def _start_build(self):
        """Start nvcc for this kernel unless its library is built; returns
        the running process or None."""
        out = self._lib_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        self._tmp, self._t0 = tmp, time.perf_counter()
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        os.replace(self._tmp, self._lib_path())
        self.build_seconds = time.perf_counter() - self._t0
        self.ptxas_info = " | ".join(
            ln.strip() for ln in log.splitlines()
            if re.search(r"registers|smem|spill", ln))

    def _load(self):
        lib = ctypes.CDLL(str(self._lib_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self.lib = lib
        return lib

    def call(self, device, *args):
        """Launch on `device`'s current stream; raises on a CUDA error."""
        if self.lib is None:
            build_kernels()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(self.lib, self.symbol)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


PAIR_WEIGHT = CudaKernel(
    "pair_weight_matrix", "pair_weight.cu", "rp_pair_weight_matrix",
    [_P, _I, _I, _F, _F, _F, _F, _F, _F, _P, _P, _P],
    replaces="relativepose_tpu/ops/pallas_kernels.py:213")
POWER_ITER = CudaKernel(
    "power_iteration", "power_iteration.cu", "rp_power_iteration",
    [_P, _P, _I, _I, _I, _P, _P],
    replaces="relativepose_tpu/ops/pallas_kernels.py:67")
KERNELS = {k.name: k for k in (PAIR_WEIGHT, POWER_ITER)}


def build_kernels():
    """Build every kernel not yet built (nvcc processes run in parallel)
    and load them.  Returns {name: CudaKernel}."""
    procs = [(k, k._start_build()) for k in KERNELS.values()
             if k.lib is None]
    for k, proc in procs:
        if proc is not None:
            k._finish_build(proc)
        k._load()
    return KERNELS


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def _check_cuda(name, tensors, dtypes):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CUDA or the CPU, "
                         f"got {dev}")
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


_HP_FIELDS = ("sigma_dist", "sigma_angle1", "sigma_angle2", "dist_thre",
              "dist_sep_thre", "angle_thre")


def check_no_grad(name, tensors, hp=None):
    """Raise if grad mode is on and any of `tensors`, or a tensor field of
    the hyper-parameters `hp`, requires grad: the CUDA kernels have no
    backward, and their results would carry no gradient."""
    if not torch.is_grad_enabled():
        return
    fields = [] if hp is None else [getattr(hp, f) for f in _HP_FIELDS]
    if any(isinstance(t, torch.Tensor) and t.requires_grad
           for t in (*tensors, *fields)):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            "requires grad; run it under torch.no_grad(), or turn it off "
            "where gradients are needed (SolverStaticConfig("
            "pallas_w_build=False, use_pallas=False), as the JAX package's "
            "grad paths do)")


# ---------------------------------------------------------------------------
# K1: pair-consistency weight matrix
# ---------------------------------------------------------------------------

_EPS = 1e-12


def pair_weight_matrix_plain(ps, pt, ns, nt, f, obs_prod, cvalid, hp):
    """The symmetric pair-consistency matrix and the early-out counts.

    Port of `relativepose_tpu/match/solver.py::pair_weight_matrix`,
    batched: ps/pt/ns/nt [B, C, 3]; f/obs_prod [B, C]; cvalid [B, C] bool;
    hp a `SolverHyperParams`.  Returns (W [B, C, C], counts) with counts a
    dict of int32 [B] tensors 'dist', 'dist_angle', 'nonzero_w' over the
    upper triangle.
    """
    dd_s = [ps[..., :, k, None] - ps[..., None, :, k] for k in range(3)]
    dd_t = [pt[..., :, k, None] - pt[..., None, :, k] for k in range(3)]
    d2_s = dd_s[0] ** 2 + dd_s[1] ** 2 + dd_s[2] ** 2
    d2_t = dd_t[0] ** 2 + dd_t[1] ** 2 + dd_t[2] ** 2
    dis_s = torch.sqrt(d2_s + 1e-20)
    dis_t = torch.sqrt(d2_t + 1e-20)
    d2 = (dis_s - dis_t) ** 2
    dist_ok = (d2 < hp.dist_thre**2) & (
        torch.minimum(dis_s, dis_t) > 1.5 * hp.dist_sep_thre**2)
    inv_s = 1.0 / torch.clamp(dis_s, min=_EPS)
    inv_t = 1.0 / torch.clamp(dis_t, min=_EPS)

    def ang_diff_sq(a, b):
        """(arccos a - arccos b)^2 with one arccos, clipped strictly
        inside [-1, 1] as in the JAX package."""
        lim = 1.0 - 1e-7
        a = torch.clamp(a, -lim, lim)
        b = torch.clamp(b, -lim, lim)
        c = a * b + torch.sqrt((1.0 - a * a) * (1.0 - b * b) + 1e-20)
        return torch.arccos(torch.clamp(c, -lim, lim)) ** 2

    nn_s = ns @ ns.transpose(-1, -2)
    nn_t = nt @ nt.transpose(-1, -2)
    alpha = ang_diff_sq(nn_s, nn_t)
    ne1_row = (ns[..., :, 0, None] * dd_s[0] + ns[..., :, 1, None] * dd_s[1]
               + ns[..., :, 2, None] * dd_s[2]) * inv_s
    ne2_row = (nt[..., :, 0, None] * dd_t[0] + nt[..., :, 1, None] * dd_t[1]
               + nt[..., :, 2, None] * dd_t[2]) * inv_t
    beta = ang_diff_sq(ne1_row, ne2_row)
    ne1_col = (ns[..., None, :, 0] * dd_s[0] + ns[..., None, :, 1] * dd_s[1]
               + ns[..., None, :, 2] * dd_s[2]) * inv_s
    ne2_col = (nt[..., None, :, 0] * dd_t[0] + nt[..., None, :, 1] * dd_t[1]
               + nt[..., None, :, 2] * dd_t[2]) * inv_t
    gamma = ang_diff_sq(ne1_col, ne2_col)

    a2 = hp.angle_thre**2
    angle_ok = (alpha < a2) & (beta < a2) & (gamma < a2)

    w = f[..., :, None] * f[..., None, :] * torch.exp(
        -d2 / (2.0 * hp.sigma_dist**2)
        - alpha / (2.0 * hp.sigma_angle1**2)
        - beta / (2.0 * hp.sigma_angle2**2)
        - gamma / (2.0 * hp.sigma_angle2**2)
    )
    all_obs = (obs_prod[..., :, None] * obs_prod[..., None, :]) == 1.0
    w = torch.where(all_obs, w, w * 0.6)

    pair_valid = cvalid[..., :, None] & cvalid[..., None, :]
    c = ps.shape[-2]
    upper = torch.ones((c, c), dtype=torch.bool, device=ps.device).triu(1)

    w = w * dist_ok * angle_ok * pair_valid
    w = torch.where(upper, w, 0.0)
    w = w + w.transpose(-1, -2)  # symmetric, zero diagonal

    def count(m):
        return m.sum(dim=(-1, -2)).to(torch.int32)

    counts = {
        "dist": count(dist_ok & pair_valid & upper),
        "dist_angle": count(dist_ok & angle_ok & pair_valid & upper),
        "nonzero_w": count((w != 0) & upper),
    }
    return w, counts


def pack_components(ps, pt, ns, nt, f, obs_prod, cvalid):
    """The kernel's input: [B, 16, C] f32 rows ps(3) pt(3) ns(3) nt(3) f obs
    valid pad, the layout of the Pallas kernel's packed components."""
    return torch.cat(
        [ps.transpose(-1, -2), pt.transpose(-1, -2), ns.transpose(-1, -2),
         nt.transpose(-1, -2), f[..., None, :], obs_prod[..., None, :],
         cvalid.to(f.dtype)[..., None, :], torch.zeros_like(f)[..., None, :]],
        dim=-2).to(torch.float32).contiguous()


def pair_weight_tiles(c):
    """Blocks per pair of the CUDA kernel: the 64x64 tile pairs (I <= J)
    of the upper triangle (TILE = 64 in csrc/pair_weight.cu)."""
    t = (c + 63) // 64
    return t * (t + 1) // 2


def pair_weight_launch(comps, hp, W, partials):
    """One launch of the CUDA kernel on packed components [B, 16, C]
    (`pack_components`) into W [B, C, C] and the count partials
    [B, pair_weight_tiles(C), 3] int32; nothing is launched (or counted)
    when B or C is 0.  The constants are folded on the host in double
    precision: -log2(e) / (2 sigma^2) for the exponent (the kernel uses
    exp2) and the squared thresholds, as the plain version computes
    them."""
    b, _, c = comps.shape
    if b == 0 or c == 0:
        return
    k = -math.log2(math.e) / 2.0
    PAIR_WEIGHT.call(
        comps.device, comps.data_ptr(), b, c,
        k / float(hp.sigma_dist) ** 2, k / float(hp.sigma_angle1) ** 2,
        k / float(hp.sigma_angle2) ** 2, float(hp.dist_thre) ** 2,
        1.5 * float(hp.dist_sep_thre) ** 2, float(hp.angle_thre) ** 2,
        W.data_ptr(), partials.data_ptr())


def pair_weight_matrix(ps, pt, ns, nt, f, obs_prod, cvalid, hp):
    """W [B, C, C] and counts, as `pair_weight_matrix_plain` returns them.

    CUDA tensors go to the CUDA kernel; CPU tensors to the plain version.
    The hyper-parameters are read as Python floats (f32 in the kernel),
    one host read per tensor field.
    """
    if ps.device.type == "cpu":
        return pair_weight_matrix_plain(ps, pt, ns, nt, f, obs_prod, cvalid,
                                        hp)
    check_no_grad("pair_weight_matrix", (ps, pt, ns, nt, f, obs_prod), hp)
    comps = pack_components(ps, pt, ns, nt, f, obs_prod, cvalid)
    _check_cuda("pair_weight_matrix", [comps], [torch.float32])
    if comps.dim() != 3 or comps.shape[1] != 16:
        raise ValueError(f"pair_weight_matrix: bad shape {tuple(ps.shape)}")
    b, _, c = comps.shape
    W = torch.empty((b, c, c), dtype=torch.float32, device=comps.device)
    partials = torch.empty((b, pair_weight_tiles(c), 3), dtype=torch.int32,
                           device=comps.device)
    pair_weight_launch(comps, hp, W, partials)
    totals = partials.sum(dim=1, dtype=torch.int32)
    counts = {"dist": totals[:, 0], "dist_angle": totals[:, 1],
              "nonzero_w": totals[:, 2]}
    return W, counts


# ---------------------------------------------------------------------------
# K2: power iteration
# ---------------------------------------------------------------------------

def power_iteration_plain(W, h, iters: int):
    """Dominant eigenvector of W o (h (+) h), batched: W [B, C, C] f32,
    h [B, C] f32 -> [B, C].  The f32 loop of the JAX package's
    `power_iteration_vmem` off the TPU."""
    v = torch.ones(h.shape, dtype=h.dtype, device=h.device)
    for _ in range(iters):
        y = W @ torch.stack([v, h * v], dim=-1)
        y = h * y[..., 0] + y[..., 1]
        n = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
        v = torch.where(n > 1e-12, y / torch.clamp(n, min=1e-12), v)
    return v


def power_iteration_launch(W, h, iters, u):
    """One launch of the CUDA kernel: W [B, C, C], h [B, C] -> u [B, C];
    nothing is launched (or counted) when B or C is 0."""
    b, c = h.shape
    if b == 0 or c == 0:
        return
    POWER_ITER.call(W.device, W.data_ptr(), h.data_ptr(), b, c, int(iters),
                    u.data_ptr())


def power_iteration_info(c):
    """The CUDA kernel's cluster size, threads per block and how many
    clusters (pairs) the current card runs at once at size C."""
    if POWER_ITER.lib is None:
        build_kernels()
    fn = POWER_ITER.lib.rp_power_iteration_info
    fn.argtypes = [_I] + [ctypes.POINTER(_I)] * 3
    fn.restype = ctypes.c_int
    out = [_I() for _ in range(3)]
    rc = fn(c, *[ctypes.byref(o) for o in out])
    if rc != 0:
        raise RuntimeError(f"power_iteration: CUDA error {rc} in info")
    return dict(zip(("cluster", "threads", "max_active_clusters"),
                    (o.value for o in out)))


def power_iteration(W, h, iters: int):
    """`power_iteration_plain` on the CPU, the CUDA kernel on CUDA."""
    if W.device.type == "cpu":
        return power_iteration_plain(W, h, iters)
    check_no_grad("power_iteration", (W, h))
    _check_cuda("power_iteration", [W, h], [torch.float32, torch.float32])
    if W.dim() != 3 or W.shape[1] != W.shape[2] or h.shape != W.shape[:2]:
        raise ValueError(f"power_iteration: bad shapes {tuple(W.shape)} "
                         f"{tuple(h.shape)}")
    u = torch.empty(h.shape, dtype=torch.float32, device=W.device)
    power_iteration_launch(W, h, iters, u)
    return u
