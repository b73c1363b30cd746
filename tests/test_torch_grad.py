"""Gradients through the port's pose solver against `jax.grad` of the JAX
package's, on the CPU.

The JAX package made every op of the solver grad-safe (the eps under each
square root, arccos clipped strictly inside [-1, 1], the Jacobi theta
clip, `where` with safe denominators, the refit's 1e-4 weight floor); the
port copied them, and here autograd of the port is held against
`jax.grad` on the same inputs:
  * the solver (`estimate_relative_pose`, plain W build) on
    `tests/test_match_solver.py::make_scene` (k=48, top_k=3, noise and
    outliers), gradients of sum(t^2) + ||R - R_gt||_F^2 with respect to
    the keypoints' feat, pc and normal of both views: max |difference|
    within 1e-3 of the largest gradient (f32 through 5 x (1 + 5) Horn
    solves and the power iterations);
  * the 4x4 Jacobi eigensolver and Horn's rotation on random inputs: to
    1e-4 of the largest gradient where the spectrum is simple; with a
    repeated eigenvalue the gradients need only be finite (the
    eigenvectors of a repeated eigenvalue are not unique).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.core import horn as jhorn
from relativepose_tpu.match import solver as jsol
from relativepose_tpu.ops import eig4x4 as jeig
from relativepose_tpu_torch.core import horn as thorn
from relativepose_tpu_torch.match import solver as tsol
from relativepose_tpu_torch.ops import eig4x4 as teig
from test_match_solver import make_scene
from torch_parity import one_torch_thread  # noqa: F401

GRAD_KEYS = ("feat", "pc", "normal")


def scene(rng, noise=0.01):
    """make_scene's keypoints with descriptors scaled by 0.02: at the
    scene's own scale each source has one non-zero affinity, whose row
    normalisation makes it exactly 1 and its gradient 0; scaled, several
    candidates per source compete and the descriptor gradients are not
    rounding noise."""
    ds, dt, T = make_scene(rng, k=48, noise=noise, outliers=6, unobserved=8)
    arrs = []
    for d in (ds, dt):
        a = {k: v.astype(np.float32) for k, v in d.items()}
        a["feat"] = (0.02 * d["feat"]).astype(np.float32)
        a["valid"] = np.ones(48, bool)
        a["valid"][-3:] = False
        arrs.append(a)
    return arrs[0], arrs[1], T.astype(np.float32)


def loss_jax(ds, dt, R, cfg):
    T = jsol.estimate_relative_pose(ds, dt, jsol.SolverHyperParams(), cfg)
    return jnp.sum(T[:3, 3] ** 2) + jnp.sum((T[:3, :3] - R) ** 2)


@pytest.mark.parametrize("kw", [dict(method="irls+sm"),
                                dict(method="spectral"),
                                dict(method="irls+sm", refit_rounds=2)],
                         ids=["irls+sm", "spectral", "irls+sm-refit2"])
def test_solver_gradients_match_jax(rng, kw):
    ds, dt, T_gt = scene(rng)
    R = T_gt[:3, :3]
    jcfg = jsol.SolverStaticConfig(top_k=3, power_iters=5,
                                   pallas_w_build=False, **kw)
    tcfg = tsol.SolverStaticConfig(top_k=3, power_iters=5,
                                   pallas_w_build=False, **kw)

    def diff_args(d):
        return {k: d[k] for k in GRAD_KEYS}

    js, jt = ({k: jnp.asarray(v) for k, v in d.items()} for d in (ds, dt))

    def jloss(gs, gt):
        return loss_jax({**js, **gs}, {**jt, **gt}, jnp.asarray(R), jcfg)

    lj, (gj_s, gj_t) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        *[{k: jnp.asarray(v) for k, v in diff_args(d).items()}
          for d in (ds, dt)])

    tin = []
    for d in (ds, dt):
        tin.append({k: torch.from_numpy(v)[None].requires_grad_(k in
                                                               GRAD_KEYS)
                    for k, v in d.items()})
    T = tsol.estimate_relative_pose(tin[0], tin[1], tsol.SolverHyperParams(),
                                    tcfg)
    lt = torch.sum(T[0, :3, 3] ** 2) + torch.sum(
        (T[0, :3, :3] - torch.from_numpy(R)) ** 2)
    lt.backward()
    assert float(lj) > 1e-6   # the pose is not exact: the gradient is not 0
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4,
                               atol=1e-7)
    for side, gj in ((0, gj_s), (1, gj_t)):
        for k in GRAD_KEYS:
            a = np.asarray(gj[k])
            b = tin[side][k].grad[0].numpy()
            assert np.isfinite(b).all(), (side, k)
            scale = np.abs(a).max()
            assert scale > 0, (side, k)
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-3 * scale,
                                       err_msg=f"view {side} {k}")


def sym4(rng, n, repeated=False):
    if repeated:
        # eigenvalues (3, 1, 1, -2): a two-dimensional eigenspace
        Q, _ = np.linalg.qr(rng.randn(n, 4, 4))
        A = Q @ (np.array([3.0, 1.0, 1.0, -2.0])[:, None] *
                 np.swapaxes(Q, -1, -2))
    else:
        A = rng.randn(n, 4, 4)
        A = A + np.swapaxes(A, -1, -2)
    return A.astype(np.float32)


@pytest.mark.parametrize("repeated", [False, True],
                         ids=["simple", "repeated"])
def test_eigensolver_gradients(rng, repeated):
    A = sym4(rng, 16, repeated)
    c = rng.randn(16, 4).astype(np.float32)
    cw = rng.randn(16, 4).astype(np.float32)

    def jl(A):
        w, _ = jeig.eigh4x4(A)
        return jnp.sum(jeig.max_eigvec4x4(A) * c) + jnp.sum(
            jnp.sort(w, -1) * cw)

    gj = np.asarray(jax.grad(jl)(jnp.asarray(A)))
    At = torch.from_numpy(A).requires_grad_(True)
    w, _ = teig.eigh4x4(At)
    lt = torch.sum(teig.max_eigvec4x4(At) * torch.from_numpy(c)) + \
        torch.sum(torch.sort(w, -1).values * torch.from_numpy(cw))
    lt.backward()
    gt = At.grad.numpy()
    assert np.isfinite(gt).all() and np.isfinite(gj).all()
    if not repeated:
        np.testing.assert_allclose(gt, gj, rtol=0,
                                   atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("repeated", [False, True],
                         ids=["simple", "degenerate"])
def test_horn_gradients(rng, repeated):
    src = rng.randn(4, 20, 3).astype(np.float32)
    if repeated:
        # every point on one line through the origin: a rotation about it
        # is free, so the N-matrix has a repeated top eigenvalue
        src = (rng.randn(4, 20, 1) * np.array([1.0, 0.0, 0.0])).astype(
            np.float32)
    tgt = (src + 0.1 * rng.randn(4, 20, 3)).astype(np.float32)
    w = rng.rand(4, 20).astype(np.float32)
    C = rng.randn(4, 3, 3).astype(np.float32)

    def jl(s, t, w):
        return jnp.sum(jhorn.horn87(s, t, w) * C)

    gj = jax.grad(jl, argnums=(0, 1, 2))(*map(jnp.asarray, (src, tgt, w)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (src, tgt, w)]
    torch.sum(thorn.horn87(*ts) * torch.from_numpy(C)).backward()
    for a, b in zip(gj, ts):
        a, b = np.asarray(a), b.grad.numpy()
        assert np.isfinite(b).all()
        if not repeated:
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-4 * np.abs(a).max())


def test_estimate_relative_pose_writes_t_in_place_under_autograd(rng):
    """estimate_relative_pose writes R and t into an identity T in place:
    autograd accepts it, and the gradient through T[:3, 3] equals the one
    through the solver's t itself (an early-out pair gets none)."""
    ds, dt, _ = scene(rng)
    batch = [{k: torch.from_numpy(np.stack([v, v])) for k, v in d.items()}
             for d in (ds, dt)]
    batch[0]["valid"][1] = False          # pair 1 takes the early-out
    pc = batch[0]["pc"].requires_grad_(True)
    cfg = tsol.SolverStaticConfig(top_k=3, power_iters=5,
                                  pallas_w_build=False)
    T = tsol.estimate_relative_pose(batch[0], batch[1],
                                    tsol.SolverHyperParams(), cfg)
    T[:, :3, 3].sum().backward()
    g = pc.grad.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g[0]).max() > 0 and np.abs(g[1]).max() == 0
    np.testing.assert_array_equal(T[1].detach().numpy(), np.eye(4))


def test_plain_w_build_takes_tensor_sigmas_with_a_graph(rng):
    """The sigma tuner differentiates the solver in the sigmas: 0-d tensor
    sigmas that carry a graph go through the plain W build (and the
    descriptor affinity) to a finite, non-zero gradient that equals
    JAX's.  Noise 0.1: at 0.01 the loss is ~6e-7 and its sigma
    gradient is set by f32 rounding inside the solve (both packages'
    f32 gradients differ from an f64 evaluation by up to 2 %)."""
    ds, dt, T_gt = scene(rng, noise=0.1)
    R = T_gt[:3, :3]
    sig0 = np.array([0.2615, 0.2615, 0.04, 0.01], np.float32)
    jcfg = jsol.SolverStaticConfig(top_k=3, power_iters=5,
                                   pallas_w_build=False)

    def jl(s):
        hp = jsol.SolverHyperParams(sigma_angle1=s[0], sigma_angle2=s[1],
                                    sigma_dist=s[2], sigma_feat=s[3])
        T = jsol.estimate_relative_pose(
            {k: jnp.asarray(v) for k, v in ds.items()},
            {k: jnp.asarray(v) for k, v in dt.items()}, hp, jcfg)
        return jnp.sum((T[:3, :3] - R) ** 2)

    gj = np.asarray(jax.jit(jax.grad(jl))(jnp.asarray(sig0)))
    s = torch.from_numpy(sig0).requires_grad_(True)
    hp = tsol.SolverHyperParams(sigma_angle1=s[0], sigma_angle2=s[1],
                                sigma_dist=s[2], sigma_feat=s[3])
    T = tsol.estimate_relative_pose(
        {k: torch.from_numpy(v)[None] for k, v in ds.items()},
        {k: torch.from_numpy(v)[None] for k, v in dt.items()}, hp,
        tsol.SolverStaticConfig(top_k=3, power_iters=5,
                                pallas_w_build=False))
    torch.sum((T[0, :3, :3] - torch.from_numpy(R)) ** 2).backward()
    gt = s.grad.numpy()
    assert np.isfinite(gt).all() and np.abs(gt).max() > 0
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-3 * np.abs(gj).max())


def test_kernel_wrappers_refuse_grad_and_keep_the_cpu_differentiable(rng):
    """The CUDA kernels have no backward.  On the CPU the wrappers run the
    plain versions, which stay differentiable (here W's gradient in the
    positions and in a tensor sigma); the rule that refuses a CUDA launch,
    `check_no_grad`, raises for an input or a tensor sigma that requires
    grad while grad mode is on, and passes under no_grad."""
    from relativepose_tpu_torch.ops import kernels
    C = 40
    ps = torch.from_numpy(rng.randn(1, C, 3).astype(np.float32))
    pt = ps + 0.01 * torch.from_numpy(rng.randn(1, C, 3).astype(np.float32))
    ns = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(1, C, 3).astype(np.float32)), dim=-1)
    f = torch.from_numpy(rng.rand(1, C).astype(np.float32))
    obs = torch.ones(1, C)
    valid = torch.ones(1, C, dtype=torch.bool)
    ps.requires_grad_(True)
    sig = torch.tensor(0.04, requires_grad=True)
    hp = tsol.SolverHyperParams(sigma_dist=sig)
    W, _ = kernels.pair_weight_matrix(ps, pt, ns, ns, f, obs, valid, hp)
    W.sum().backward()
    assert float(ps.grad.abs().max()) > 0 and float(sig.grad.abs()) > 0
    u = kernels.power_iteration(W, torch.ones(1, C, requires_grad=True), 3)
    assert u.requires_grad

    with pytest.raises(RuntimeError, match="no backward"):
        kernels.check_no_grad("pair_weight_matrix", (ps, pt), None)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.check_no_grad("pair_weight_matrix", (pt,), hp)
    kernels.check_no_grad("pair_weight_matrix", (pt,),
                          tsol.SolverHyperParams())
    with torch.no_grad():
        kernels.check_no_grad("pair_weight_matrix", (ps, pt), hp)
        kernels.check_no_grad("power_iteration", (W,))
