"""train/finetune_pose.py of relativepose_tpu_torch against
relativepose_tpu, on the CPU.

The small pipeline of `tests/torch_parity.py` (n_detect=32, n_match=16,
n_random=8, power_iters=5, the plain W build) on two synthetic suncg
pairs, with an f32 SCNet at ngf 8 whose Flax parameters come from a numpy
seed and are converted by `models/convert.py`; the port gets the JAX
package's keypoint draws.  Tolerances:
  * the loss and its parts to 1e-2 relative: they are sums of squares of
    pose errors of order 1, and `tests/test_torch_pipeline.py` holds an
    SCNet step's pose to 1e-3, which moves trans_se (~0.43 here) by a few
    1e-3 (measured here: 1.6e-4 on rot_frob2, 4.6e-3 on trans_se);
  * the gradients by the scheme of `tests/test_torch_train.py`, relative
    L2 per tensor and over all of them, at bounds set by how sensitive
    this gradient is: perturbing SCNet's parameters by 1e-6 relative
    moves either package's gradient by 0.2 % (0.4 % in the worst tensor),
    by 1e-4 relative by 25 % (30 %), and the two packages' f32 SCNet
    outputs differ by ~1e-5 relative.  Measured between the packages: 3.4
    % over all tensors, 10.7 % in the worst one, 2 % on the raw gradient
    norm.  Bounds: 0.1 over all, 0.25 per tensor, 5e-2 on the norm;
  * the parameters after the update: Adam's first step moves a parameter
    by about lr * sign(gradient), so all within 2.1 lr (a sign that flips
    on a near-zero gradient; with the gradient differences above 3.6 % of
    the parameters flip here) and 95 % within 1e-7 (f32 rounding of
    p - lr at parameters of order 1);
  * the optimizer chain against optax's on the same gradients: updates
    and parameters to 1e-9 (parameters of order 1e-3, updates of 1e-3).
The port's own checks of remat and of the anchor term are in
`tests/test_torch_remat.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from relativepose_tpu.eval import harness as jharness
from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.train import finetune_pose as jft
from relativepose_tpu_torch.data import device_store as tstore
from relativepose_tpu_torch.data import synthetic
from relativepose_tpu_torch.eval import harness as tharness
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.pipeline import recurrent as trec
from relativepose_tpu_torch.train import finetune_pose as tft
from torch_parity import (
    configs,
    flax_scnet_params,
    jax_detection_mask,
    jax_pipeline_draws,
    pairs,
)
from test_torch_train import assert_grads, flat
from torch_parity import one_torch_thread  # noqa: F401

LR = 1e-5
METRIC_RTOL = 1e-2


def pipe_configs(steps, remat=True):
    jcfg, tcfg = configs()
    kw = dict(alter_steps=steps, remat=remat)
    return (dataclasses.replace(jcfg, solver=dataclasses.replace(
                jcfg.solver, pallas_w_build=False), **kw),
            dataclasses.replace(tcfg, solver=dataclasses.replace(
                tcfg.solver, pallas_w_build=False), **kw))


def sigma_tables(steps):
    table = tharness.default_sigma_table("suncg")[:steps]
    return (jharness.hyper_params_from_table(table, alter_steps=steps),
            tharness.hyper_params_from_table(table, alter_steps=steps))


def jax_loss_fn(step_fn):
    """The `loss_fn` closure of the JAX package's `make_finetune_step`."""
    return next(c.cell_contents for c in step_fn.__closure__
                if getattr(c.cell_contents, "__name__", "") == "loss_fn")


@pytest.fixture(scope="module")
def step_case():
    """The JAX package's step (its own loss_fn, gradients by jax.grad, its
    optimizer) on 2 pairs at alter_steps=1, and the port's inputs."""
    jcfg, tcfg = pipe_configs(1, remat=False)
    hp_j, hp_t = sigma_tables(1)
    ft_j = jft.PoseFinetuneConfig(ngf=8, learning_rate=LR)
    params = flax_scnet_params(FlaxSCNet(ngf=8))
    ds, dt, T_gt = pairs([0, 1])
    T_gt = T_gt.astype(np.float32)
    jds = {k: jnp.asarray(v) for k, v in ds.items()}
    jdt = {k: jnp.asarray(v) for k, v in dt.items()}
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    loss_fn = jax_loss_fn(jft.make_finetune_step(jcfg, hp_j, ft_j))
    (_, mj), gj = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, params, jds, jdt, jnp.asarray(T_gt), keys)
    tx = jft.make_optimizer(ft_j)
    updates, _ = tx.update(gj, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    mj = {k: float(v) for k, v in mj.items()}
    mj["grad_norm"] = float(optax.global_norm(gj))
    det = [np.stack([jax_detection_mask({k: v[b] for k, v in d.items()},
                                        jcfg) for b in range(2)])
           for d in (jds, jdt)]
    draws = jax_pipeline_draws(keys, 1, det[0], det[1], jcfg.keypoints)
    port = dict(ds=trec.as_pair_batch(ds, "cpu"),
                dt=trec.as_pair_batch(dt, "cpu"),
                T_gt=torch.from_numpy(T_gt), draws=draws, cfg=tcfg, hp=hp_t)
    jres = dict(metrics=mj, grads=jax.tree.map(np.asarray, gj),
                params=jax.tree.map(np.asarray, new))
    return params, jres, port


def port_net(params):
    return convert.load_flax_params(SCNet(ngf=8), params)


def test_loss_and_gradients_match_jax(step_case):
    params, jres, p = step_case
    net = port_net(params)
    ft = tft.PoseFinetuneConfig(ngf=8, learning_rate=LR)
    loss, mt = tft.loss_fn(net, None, p["ds"], p["dt"], p["T_gt"], p["cfg"],
                           p["hp"], ft, draws=p["draws"])
    loss.backward()
    for k in ("loss", "rot_frob2", "trans_se"):
        np.testing.assert_allclose(float(mt[k].detach()),
                                   jres["metrics"][k], rtol=METRIC_RTOL,
                                   err_msg=k)
    gt = convert.flax_params(net, grads=True)
    for g in flat(gt).values():
        assert np.isfinite(g).all()
    assert_grads(gt, jres["grads"], l2_rel=0.25, total_rel=0.1)


def test_step_metrics_and_update_match_jax(step_case):
    params, jres, p = step_case
    net = port_net(params)
    ft = tft.PoseFinetuneConfig(ngf=8, learning_rate=LR)
    state = tft.init_state(net, ft)
    step = tft.make_finetune_step(p["cfg"], p["hp"], ft)
    m = step(state, p["ds"], p["dt"], p["T_gt"], draws=p["draws"])
    assert state.step == 1
    for k in ("loss", "rot_frob2", "trans_se"):
        np.testing.assert_allclose(float(m[k]), jres["metrics"][k],
                                   rtol=METRIC_RTOL, err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               jres["metrics"]["grad_norm"], rtol=5e-2)
    assert jres["metrics"]["grad_norm"] > 1.0   # the clip is active
    pt, pj = flat(convert.flax_params(net)), flat(jres["params"])
    assert set(pt) == set(pj)
    d = np.concatenate([np.abs(pt[k] - pj[k]).ravel() for k in pj])
    assert d.max() <= 2.1 * LR
    assert (d <= 1e-7).mean() >= 0.95
    moved = np.concatenate([np.abs(pt[k] - flat(params)[k]).ravel()
                            for k in pj])
    assert np.median(moved) > 0.5 * LR    # every parameter stepped


@pytest.mark.parametrize("scale", [1e3, 1e-3], ids=["clipped", "unclipped"])
def test_optimizer_chain_matches_optax(rng, scale):
    """zero_nans -> clip_by_global_norm(1) -> adam, three steps on
    gradients with NaN entries, with global norms above and below the
    clip."""
    shapes = [(4, 3), (7,), (2, 2, 2)]
    # parameters of order 1e-3, so that an update read back as a
    # difference of parameters keeps its digits
    p0 = [(1e-3 * rng.randn(*s)).astype(np.float32) for s in shapes]
    grads = []
    for _ in range(3):
        g = [(scale * rng.randn(*s)).astype(np.float32) for s in shapes]
        g[0][1, 2] = np.nan
        g[2][0, 1, 0] = np.nan
        grads.append(g)
    cfg = tft.PoseFinetuneConfig(learning_rate=1e-3)
    tx = jft.make_optimizer(cfg)
    pj = [jnp.asarray(p) for p in p0]
    state = tx.init(pj)
    pt = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    opt = tft.make_optimizer(pt, cfg)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, pj)
        pj = optax.apply_updates(pj, updates)
        before = [p.detach().clone() for p in pt]
        for p, c in zip(pt, tft.zero_nans_and_clip(
                [torch.from_numpy(x) for x in g], cfg.clip_norm)):
            p.grad = c
        opt.step()
        for b, p, u in zip(before, pt, updates):
            np.testing.assert_allclose((p.detach() - b).numpy(),
                                       np.asarray(u), rtol=0, atol=1e-9)
    raw = [torch.from_numpy(x) for x in grads[0]]
    assert not np.isfinite(float(tft.global_norm(raw)))   # raw: NaN
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-9)


@pytest.mark.parametrize("dataset", ["suncg", "scannet"])
def test_gather_eval_pairs_bit_equal_to_jax(dataset):
    """The decoded views (and for ScanNet the detection frames) equal the
    JAX package's compiled gather bit for bit; T_gt to 1e-6."""
    items = []
    for i in range(3):
        s, t, T = synthetic.make_pair(i, dataset, max_baseline=0.5)
        items.append(dict(data_s=s, data_t=t, T_gt=T))
    store = tstore.DeviceStore(items, device="cpu")
    arrays = {k: v.numpy() for k, v in store.arrays.items()}
    arrays["depth"] = arrays["depth"].view(np.uint16)
    idx = np.array([2, 0], np.int32)
    jds, jdt, jT = jax.jit(jft.gather_eval_pairs)(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(idx))
    tds, tdt, tT = tft.gather_eval_pairs(store.arrays,
                                         torch.from_numpy(idx).long())
    assert set(tds) == set(jds)
    assert ("rgb_full" in tds) == (dataset == "scannet")
    for a, b in ((jds, tds), (jdt, tdt)):
        for k in a:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]),
                                          err_msg=k)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-6)
