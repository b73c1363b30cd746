"""The port's training steps against relativepose_tpu.train, on the CPU.

Small networks (Resnet18_8s at base_width 8, SCNet at ngf 8, f32) start
from the JAX package's initial parameters, converted by
`models/convert.py`; both packages train on the same batch, assembled by
the JAX package's compiled pipeline from two synthetic suncg pairs, with
the JAX package's draws (negatives, the completion step's input type)
handed to the port.  Tolerances:
  * every metric of the loss dict: 1e-4 relative, 1e-6 absolute (f32
    sums over 10^5-10^6 terms in another order; the completion step's
    teacher features differ by ~3e-5, which loss_fc carries); 1e-3 for
    the metrics of a second step, whose parameters already differ as
    below;
  * the gradients, through `convert.flax_params(grads=True)`: the
    feature net's within 1e-3 of each tensor's largest gradient; SCNet's
    within 5e-2 relative L2 per tensor and 5e-3 over all of them, and
    the port's f32 gradients within 1e-2 relative L2 of its own f64
    ones (netF target).  SCNet's
    1x1 bottleneck normalises over 4n values per channel, where f32
    rounding is amplified: the JAX package's f32 gradients there differ
    from an f64 evaluation of the same loss by up to ~4%, the port's by
    ~1e-4 (measured on these inputs);
  * the parameters after 2 Adam steps, the second on a batch with no
    valid correspondence set (the feature step multiplies its gradients
    by 0 and still steps Adam).  Adam's first step moves each parameter
    by lr * sign(gradient), so a near-zero gradient whose sign differs
    between the packages moves it the other way: all parameters within
    8.4e-4 (with betas (0.5, 0.999) two steps move a parameter by at
    most 2.06 lr in each package); the feature net's within 2e-6 (1% of lr)
    except at most 1e-4 of them, SCNet's within 1e-4 for 99% of them
    (its second step carries the gradient differences above).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.data import pipeline as jpipe
from relativepose_tpu.train import completion as jcomp
from relativepose_tpu.train import feature as jfeat
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.train import completion as tcomp
from relativepose_tpu_torch.train import feature as tfeat
from relativepose_tpu_torch.train import losses as tl
from torch_parity import synthetic_pair_arrays
from torch_parity import one_torch_thread  # noqa: F401

METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
SECOND_RTOL = 1e-3   # a second step's metrics: its parameters differ
ADAM_BOUND = 8.4e-4   # 2 x 2.06 lr


@pytest.fixture(scope="module")
def batches():
    """Two JAX-assembled batches of 2 suncg pairs as numpy dicts; the
    second has no valid correspondence set."""
    a = synthetic_pair_arrays([0, 1, 2, 3], "suncg")
    fn = jax.jit(jax.vmap(lambda r, n, d, p, s, k: jpipe.assemble_pair_batch(
        r, n, d, p, s, k, "suncg")))
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    out = jax.tree.map(np.asarray, fn(
        *(jnp.asarray(a[k].astype(np.float32))
          for k in ("rgb", "norm", "depth", "pose")),
        jnp.asarray(a["segm"].astype(np.int32)), keys))
    b1 = jax.tree.map(lambda x: x[:2], out)
    b2 = jax.tree.map(lambda x: x[2:], out)
    b2["denseCorres"]["valid"] = np.zeros_like(b2["denseCorres"]["valid"])
    assert b1["denseCorres"]["valid"].all()
    return b1, b2


def to_jax(b):
    return jax.tree.map(jnp.asarray, b)


def to_torch(b):
    def conv(x):
        t = torch.from_numpy(np.array(x))
        return t.long() if t.dtype == torch.int32 and t.dim() > 1 else t
    return jax.tree.map(conv, b)


def negatives(key, batch):
    """The hard-negative candidate draws `contrastive_loss` makes."""
    n = batch["rgb"].shape[0]
    ky, kx = jax.random.split(key)
    return tl.NegativeDraws(
        torch.from_numpy(np.asarray(
            jax.random.randint(ky, (n, 1024), 0, 160))).long(),
        torch.from_numpy(np.asarray(
            jax.random.randint(kx, (n, 1024), 0, 640))).long())


def completion_draws(key, batch):
    k1, k2, _ = jax.random.split(key, 3)
    return tcomp.CompletionDraws(
        torch.tensor(bool(jax.random.bernoulli(k1))), negatives(k2, batch))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def assert_metrics(mt, mj, rtol=METRIC_RTOL):
    assert set(mj) <= set(mt)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=rtol,
                                   atol=METRIC_ATOL, err_msg=k)


def assert_grads(gt, gj, max_rel=None, l2_rel=None, total_rel=None):
    """Per tensor: max-abs within max_rel of the tensor's largest
    gradient, or relative L2 within l2_rel; all tensors together within
    total_rel relative L2."""
    gt, gj = flat(gt), flat(gj)
    assert set(gt) == set(gj)
    for k in gj:
        if max_rel is not None:
            scale = max(float(np.abs(gj[k]).max()), 1e-12)
            np.testing.assert_allclose(gt[k], gj[k], atol=max_rel * scale,
                                       err_msg=k)
        if l2_rel is not None:
            assert rel_l2(gt[k], gj[k]) <= l2_rel, k
    if total_rel is not None:
        keys = sorted(gj)
        assert rel_l2(np.concatenate([gt[k].ravel() for k in keys]),
                      np.concatenate([gj[k].ravel() for k in keys])) \
            <= total_rel


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_params(pt, pj, tol, frac):
    """All parameters within ADAM_BOUND; at least `frac` of them within
    `tol`."""
    pt, pj = flat(pt), flat(pj)
    assert set(pt) == set(pj)
    d = np.concatenate([np.abs(pt[k] - pj[k]).ravel() for k in pj])
    assert d.max() <= ADAM_BOUND
    assert (d <= tol).mean() >= frac


def feature_pair(segm):
    cfg_j = jfeat.FeatureTrainConfig(base_width=8, featlearn_segm=segm)
    cfg_t = tfeat.FeatureTrainConfig(base_width=8, featlearn_segm=segm)
    state_j = jfeat.init_state(jax.random.PRNGKey(0), cfg_j)
    state_t = tfeat.init_state(cfg_t, "cpu")
    for name in ("net_f", "seg"):
        convert.load_flax_params(state_t.models[name],
                                 state_j["params"][name])
    return cfg_j, cfg_t, state_j, state_t


@pytest.mark.parametrize("segm", [False, True])
def test_feature_loss_and_gradients_match_jax(batches, segm):
    cfg_j, cfg_t, state_j, state_t = feature_pair(segm)
    b = batches[0]
    key = jax.random.PRNGKey(7)
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, bb, k: jfeat.loss_fn(p, bb, k, cfg_j), has_aux=True))(
        state_j["params"], to_jax(b), key)
    total, mt = tfeat.loss_fn(state_t.models, to_torch(b),
                              negatives(key, b), cfg_t)
    total.backward()
    assert_metrics(mt, mj)
    assert_grads({n: convert.flax_params(m, grads=True)
                  for n, m in state_t.models.items()}, gj, max_rel=1e-3)


def test_feature_adam_steps_match_jax(batches):
    """Two steps; the second batch has no valid correspondences."""
    cfg_j, cfg_t, state_j, state_t = feature_pair(False)
    step = jax.jit(jfeat.make_train_step(cfg_j))
    for i, b in enumerate(batches):
        key = jax.random.PRNGKey(10 + i)
        state_j, mj = step(state_j, to_jax(b), key)
        mt = tfeat.train_step(state_t, to_torch(b), negatives(key, b), cfg_t)
        assert_metrics(mt, mj, METRIC_RTOL if i == 0 else SECOND_RTOL)
    assert state_t.step == int(state_j["step"]) == 2
    assert_params(state_t.params_tree(),
                  jax.tree.map(np.asarray, state_j["params"]), 2e-6,
                  1 - 1e-4)


def completion_pair(**kw):
    small = dict(ngf=8, base_width=8)
    cfg_j = jcomp.CompletionTrainConfig(**small, **kw)
    cfg_t = tcomp.CompletionTrainConfig(**small, **kw)
    state_j = jcomp.init_state(jax.random.PRNGKey(0), cfg_j)
    net_f = convert.load_flax_params(tcomp.build_models(cfg_t)[1],
                                     state_j["net_f_params"])
    state_t = tcomp.init_state(cfg_t, "cpu", net_f=net_f)
    convert.load_flax_params(state_t.models["net_g"], state_j["params"])
    return cfg_j, cfg_t, state_j, state_t


@pytest.mark.parametrize("options", [
    {},
    dict(geometric_weight=True, dynamic_weighting=True, pn_loss=True,
         fc_weight_mode="uniform", fc_scale=2.0, w_depth=3.0),
    dict(fc_target="photometric", hard_negatives=False),
], ids=["defaults", "weights_pn", "photometric_uniform"])
def test_completion_loss_and_gradients_match_jax(batches, options):
    cfg_j, cfg_t, state_j, state_t = completion_pair(**options)
    b = batches[0]
    key = jax.random.PRNGKey(8)
    (_, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, bb, k: jcomp.loss_fn(p, state_j["net_f_params"], bb, k,
                                       cfg_j), has_aux=True))(
        state_j["params"], to_jax(b), key)
    draws = completion_draws(key, b)
    if not cfg_t.hard_negatives:
        k2 = jax.random.split(key, 3)[1]
        ky, kx = jax.random.split(k2)
        shape = (2, 2000, 100)
        draws = draws._replace(negatives=tl.NegativeDraws(
            torch.from_numpy(np.asarray(
                jax.random.randint(ky, shape, 0, 160))).long(),
            torch.from_numpy(np.asarray(
                jax.random.randint(kx, shape, 0, 640))).long()))
    total, mt = tcomp.loss_fn(state_t.models["net_g"], state_t.frozen["net_f"],
                              to_torch(b), draws, cfg_t)
    total.backward()
    assert_metrics(mt, mj)
    g32 = convert.flax_params(state_t.models["net_g"], grads=True)
    assert_grads(g32, gj, l2_rel=5e-2, total_rel=5e-3)
    assert all(p.grad is None for p in state_t.frozen["net_f"].parameters())
    if cfg_t.fc_target != "netf":
        return
    # the port's own f64 gradients
    net_g = copy.deepcopy(state_t.models["net_g"]).double()
    net_f = copy.deepcopy(state_t.frozen["net_f"]).double()
    b64 = jax.tree.map(lambda x: x.double() if x.is_floating_point() else x,
                       to_torch(b))
    tcomp.loss_fn(net_g, net_f, b64, draws, cfg_t)[0].backward()
    assert_grads(g32, convert.flax_params(net_g, grads=True), l2_rel=1e-2)


def test_completion_adam_steps_match_jax(batches):
    cfg_j, cfg_t, state_j, state_t = completion_pair()
    step = jax.jit(jcomp.make_train_step(cfg_j))
    for i, b in enumerate(batches):
        key = jax.random.PRNGKey(20 + i)
        state_j, mj = step(state_j, to_jax(b), key)
        mt = tcomp.train_step(state_t, to_torch(b), completion_draws(key, b),
                              cfg_t)
        assert_metrics(mt, mj, METRIC_RTOL if i == 0 else SECOND_RTOL)
    assert_params(state_t.params_tree(),
                  jax.tree.map(np.asarray, state_j["params"]), 1e-4, 0.99)


@pytest.mark.parametrize("betas", [(0.5, 0.999), (0.9, 0.999)],
                         ids=["b1_0.5", "b1_0.9"])
def test_optax_adam_matches_optax(betas):
    """`OptaxAdam` (pose fine-tuning, sigma tuning) against optax.adam:
    three steps, one of them on zero gradients, parameters to 1e-9
    (updates of order lr = 2e-4)."""
    import optax
    from relativepose_tpu_torch.train.state import OptaxAdam
    r = np.random.RandomState(2)
    shapes = [(5, 3), (4,), (2, 3, 2)]
    p0 = [(1e-3 * r.randn(*s)).astype(np.float32) for s in shapes]
    grads = [[(r.randn(*s) * 10.0 ** r.randint(-3, 2)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    grads[1] = [np.zeros(s, np.float32) for s in shapes]
    tx = optax.adam(2e-4, b1=betas[0], b2=betas[1])
    pj = [jnp.asarray(p) for p in p0]
    state = tx.init(pj)
    pt = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    opt = OptaxAdam(pt, 2e-4, betas)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, pj)
        pj = optax.apply_updates(pj, updates)
        for p, x in zip(pt, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=1e-9)
    assert all(float(opt.state[p]["step"]) == 3.0 for p in pt)
