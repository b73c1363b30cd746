"""Resuming a training run across the packages, on the CPU.

A JAX trainer state ({'params', 'opt_state': optax.adam's, 'step'}, as
the JAX package's training CLIs save it) after one step of the JAX
package's `make_train_step`, saved by its orbax `CheckpointManager`: the
port's `CheckpointManager.restore_into` (what `--resume` runs) must give
the JAX parameters, as `models/convert.py` lays them out, and the Adam
moments and counts bit for bit; one further step of each package on the
same batch is then held to the bounds of `tests/test_torch_train.py`.
The other way, a port state after one port step, saved by the port's
manager: the JAX manager's `restore_into` of a JAX template state must
give the port's `flax_state()` (params, mu, nu, count, step) bit for bit,
and the next steps are held to the same bounds.  The jitted JAX steps are
compiled once for the module.  A port state also resumes from the npz pair
that the port's manager wrote before it wrote orbax (runs of earlier
versions), written here by hand.

The JAX state starts from the port's own seeded networks (converted by
`convert.flax_params`, with `optax.adam(...).init`), which is the JAX
trainers' state layout without the cost of an eager Flax init; the port
resumes into networks of another seed.
"""

import os

import jax
import numpy as np
import optax
import pytest

from relativepose_tpu.train import completion as jcomp
from relativepose_tpu.train import feature as jfeat
from relativepose_tpu.utils.checkpoint import CheckpointManager as JaxManager
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.train import state as tstate
from relativepose_tpu_torch.train import completion as tcomp
from relativepose_tpu_torch.train import feature as tfeat
from relativepose_tpu_torch.utils import checkpoint as tckpt
from test_torch_train import (  # noqa: F401  (batches: a fixture)
    METRIC_RTOL,
    assert_metrics,
    assert_params,
    batches,
    completion_draws,
    flat,
    negatives,
    to_jax,
    to_torch,
)
from torch_parity import one_torch_thread  # noqa: F401


def assert_resumed(state_t, state_j):
    """The port's state after `restore_into` equals the JAX state: the
    parameters as `convert` lays them out, the moments, the counts."""
    adam = state_j["opt_state"][0]
    arrays = state_t.resume_arrays()
    assert int(arrays["step"]) == int(state_j["step"])
    for name, model in state_t.models.items():
        def sub(tree):
            return tree if name == state_t.root else tree[name]
        for prefix, src, moments in (("param", state_j["params"], False),
                                     ("exp_avg", adam.mu, True),
                                     ("exp_avg_sq", adam.nu, True)):
            want = convert.torch_arrays(model, jax.tree.map(np.asarray,
                                                            sub(src)),
                                        moments)
            for k, t in want.items():
                np.testing.assert_array_equal(arrays[f"{prefix}/{name}.{k}"],
                                              t.numpy(), err_msg=k)
        for k, _ in model.named_parameters():
            assert arrays[f"adam_step/{name}.{k}"] == float(adam.count)


SETUPS = {
    "feature": (jfeat.FeatureTrainConfig(base_width=8),
                tfeat.FeatureTrainConfig(base_width=8), 2e-6, 1 - 1e-4),
    "completion": (jcomp.CompletionTrainConfig(ngf=8, base_width=8),
                   tcomp.CompletionTrainConfig(ngf=8, base_width=8), 1e-4,
                   0.99),
}


@pytest.fixture(scope="module")
def jax_steps():
    """The jitted JAX training steps, shared by the tests of the module."""
    return {"feature": jax.jit(jfeat.make_train_step(SETUPS["feature"][0])),
            "completion": jax.jit(jcomp.make_train_step(
                SETUPS["completion"][0]))}


def port_state(kind, seed):
    cfg_t = SETUPS[kind][1]
    mod = tfeat if kind == "feature" else tcomp
    return mod.init_state(cfg_t, "cpu", seed=seed)


def port_step(kind, state_t, b, key):
    cfg_t = SETUPS[kind][1]
    if kind == "feature":
        return tfeat.train_step(state_t, to_torch(b), negatives(key, b),
                                cfg_t)
    return tcomp.train_step(state_t, to_torch(b), completion_draws(key, b),
                            cfg_t)


def jax_tree(state_t):
    """A port state's networks as a fresh JAX trainer state (optax.adam's
    init), the JAX trainers' layout without an eager Flax init."""
    cfg_j = SETUPS["feature" if state_t.root is None else "completion"][0]
    tree = {"params": state_t.params_tree()}
    if "net_f" in state_t.frozen:
        tree["net_f_params"] = convert.flax_params(state_t.frozen["net_f"])
    tx = optax.adam(cfg_j.learning_rate, b1=cfg_j.b1, b2=cfg_j.b2)
    tree.update(opt_state=tx.init(tree["params"]), step=0)
    return tree


@pytest.mark.parametrize("kind", ["feature", "completion"])
def test_resume_from_jax_training_state(tmp_path, batches, jax_steps, kind):
    """One JAX step, saved by the JAX manager; the port resumes from it
    bit for bit, and its next step agrees with the JAX package's next."""
    tol, frac = SETUPS[kind][2:]
    state_j = jax_tree(port_state(kind, 0))
    state_t = port_state(kind, 1)
    step_j = jax_steps[kind]
    b1, b2 = batches
    state_j, _ = step_j(state_j, to_jax(b1), jax.random.PRNGKey(30))
    state_j = jax.device_get(state_j)
    JaxManager(str(tmp_path / "params")).save(1, state_j)
    d = str(tmp_path / "params")
    state_t, ok = tckpt.CheckpointManager(d).restore_into(state_t)
    assert ok
    assert_resumed(state_t, state_j)
    if kind == "completion":
        want = convert.torch_arrays(state_t.frozen["net_f"], jax.tree.map(
            np.asarray, state_j["net_f_params"]))
        for k, p in state_t.frozen["net_f"].named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          want[k].numpy(), err_msg=k)
    key = jax.random.PRNGKey(31)
    state_j, mj = step_j(state_j, to_jax(b2), key)
    mt = port_step(kind, state_t, b2, key)
    assert_metrics(mt, mj, METRIC_RTOL)
    assert state_t.step == int(state_j["step"]) == 2
    assert_params(state_t.params_tree(),
                  jax.tree.map(np.asarray, state_j["params"]), tol, frac)


def assert_same_arrays(got, want, what):
    got, want = flat(got), flat(want)
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", ["feature", "completion"])
def test_jax_resumes_from_port_training_state(tmp_path, batches, jax_steps,
                                              kind):
    """One port step, saved by the port's manager; the JAX manager's
    restore_into of a JAX template state (networks of another seed, zero
    moments) takes the port's params, moments, count and step bit for bit,
    and its next step agrees with the port's next."""
    tol, frac = SETUPS[kind][2:]
    state_t = port_state(kind, 0)
    b1, b2 = batches
    port_step(kind, state_t, b1, jax.random.PRNGKey(30))
    d = str(tmp_path / "params")
    tckpt.CheckpointManager(d).save(1, state_t)
    want = state_t.flax_state()
    state_j, ok = JaxManager(d).restore_into(jax_tree(port_state(kind, 1)))
    assert ok
    adam_j, empty = state_j["opt_state"]
    adam_t = want["opt_state"][0]
    assert type(adam_j).__name__ == "ScaleByAdamState"
    assert type(empty).__name__ == "EmptyState"
    assert_same_arrays(state_j["params"], want["params"], "params")
    assert_same_arrays(adam_j.mu, adam_t.mu, "mu")
    assert_same_arrays(adam_j.nu, adam_t.nu, "nu")
    if kind == "completion":
        assert_same_arrays(state_j["net_f_params"], want["net_f_params"],
                           "net_f_params")
    for got in (adam_j.count, state_j["step"]):
        assert np.asarray(got).dtype == np.int32 and int(got) == 1
    assert isinstance(adam_t, tstate.ScaleByAdamState) and \
        int(adam_t.count) == 1
    key = jax.random.PRNGKey(31)
    state_j, mj = jax_steps[kind](state_j, to_jax(b2), key)
    mt = port_step(kind, state_t, b2, key)
    assert_metrics(mt, mj, METRIC_RTOL)
    assert state_t.step == int(state_j["step"]) == 2
    assert_params(state_t.params_tree(),
                  jax.tree.map(np.asarray, state_j["params"]), tol, frac)


def test_port_resumes_from_npz_pair(tmp_path, batches):
    """The npz pair of an earlier port run (the parameter tree in f16 and
    the resume arrays in f32, as its manager wrote them after one step):
    `restore_into` takes the f32 parameters, moments and counts bit for
    bit; the next save is an orbax checkpoint kept beside the pair, and
    counts on from the pair's step."""
    state = port_state("feature", 0)
    port_step("feature", state, batches[0], jax.random.PRNGKey(30))
    d = str(tmp_path / "params")
    m = tckpt.CheckpointManager(d)
    tckpt.save_params_npz(m.npz_path(1), state.params_tree())
    np.savez(m.npz_path(1, resume=True), **state.resume_arrays())
    resumed, ok = m.restore_into(port_state("feature", 1))
    assert ok and m.all_steps() == [1]
    want, got = state.resume_arrays(), resumed.resume_arrays()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    port_step("feature", resumed, batches[1], jax.random.PRNGKey(31))
    m.save(2, resumed)
    assert sorted(os.listdir(d)) == ["checkpoint_0001.npz",
                                     "checkpoint_0001.resume.npz",
                                     "checkpoint_0002"]
    saved = tckpt.restore_params(d)
    assert int(saved["step"]) == int(saved["opt_state"][0]["count"]) == 2
