"""Resuming a JAX training run on the port, on the CPU.

A JAX trainer state ({'params', 'opt_state': optax.adam's, 'step'}, as
the JAX package's training CLIs save it) after one step of the JAX
package's `make_train_step`, saved by its orbax `CheckpointManager`: the
port's `CheckpointManager.restore_into` (what `--resume` runs) must give
the JAX parameters, as `models/convert.py` lays them out, and the Adam
moments and counts bit for bit; one further step of each package on the
same batch is then held to the bounds of `tests/test_torch_train.py`.

The JAX state starts from the port's own seeded networks (converted by
`convert.flax_params`, with `optax.adam(...).init`), which is the JAX
trainers' state layout without the cost of an eager Flax init; the port
resumes into networks of another seed.
"""

import jax
import numpy as np
import optax
import pytest

from relativepose_tpu.train import completion as jcomp
from relativepose_tpu.train import feature as jfeat
from relativepose_tpu.utils.checkpoint import CheckpointManager as JaxManager
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.train import completion as tcomp
from relativepose_tpu_torch.train import feature as tfeat
from relativepose_tpu_torch.utils import checkpoint as tckpt
from test_torch_train import (  # noqa: F401  (batches: a fixture)
    METRIC_RTOL,
    assert_metrics,
    assert_params,
    batches,
    completion_draws,
    negatives,
    to_jax,
    to_torch,
)


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


@pytest.mark.parametrize("kind", ["feature", "completion"])
def test_resume_from_jax_training_state(tmp_path, batches, kind):
    """One JAX step, saved by the JAX manager; the port resumes from it
    bit for bit, and its next step agrees with the JAX package's next."""
    if kind == "feature":
        cfg_j = jfeat.FeatureTrainConfig(base_width=8)
        cfg_t = tfeat.FeatureTrainConfig(base_width=8)
        seeded = tfeat.init_state(cfg_t, "cpu")
        state_j = {"params": seeded.params_tree()}
        state_t = tfeat.init_state(cfg_t, "cpu", seed=1)
        step_j = jax.jit(jfeat.make_train_step(cfg_j))

        def step_t(b, key):
            return tfeat.train_step(state_t, to_torch(b), negatives(key, b),
                                    cfg_t)
        tol, frac = 2e-6, 1 - 1e-4
    else:
        cfg_j = jcomp.CompletionTrainConfig(ngf=8, base_width=8)
        cfg_t = tcomp.CompletionTrainConfig(ngf=8, base_width=8)
        seeded = tcomp.init_state(cfg_t, "cpu")
        state_j = {"params": seeded.params_tree(), "net_f_params":
                   convert.flax_params(seeded.frozen["net_f"])}
        state_t = tcomp.init_state(cfg_t, "cpu", seed=1)
        step_j = jax.jit(jcomp.make_train_step(cfg_j))

        def step_t(b, key):
            return tcomp.train_step(state_t, to_torch(b),
                                    completion_draws(key, b), cfg_t)
        tol, frac = 1e-4, 0.99
    tx = optax.adam(cfg_j.learning_rate, b1=cfg_j.b1, b2=cfg_j.b2)
    state_j.update(opt_state=tx.init(state_j["params"]), step=0)
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
    mt = step_t(b2, key)
    assert_metrics(mt, mj, METRIC_RTOL)
    assert state_t.step == int(state_j["step"]) == 2
    assert_params(state_t.params_tree(),
                  jax.tree.map(np.asarray, state_j["params"]), tol, frac)


