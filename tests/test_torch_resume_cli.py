"""`--resume` of the port's training CLIs on an experiment directory that
the JAX package's CLI wrote, on the CPU.

An orbax `checkpoint_0001/` of a JAX trainer state 5 steps in (the JAX
trainers' layout: params, optax.adam's state, step; the networks are the
port's, seeded, through `convert.flax_params`), saved by the JAX
package's `CheckpointManager` into `experiments/exp_<name>/params`.  Both
CLIs run at the small size of `tests/test_torch_train_cli.py`, streaming
their synthetic pairs (`--device_data 0`).  That the resumed state equals
the JAX state bit for bit is `tests/test_torch_orbax_resume.py`'s, and so
is resuming from the npz pair of an earlier port run.
"""

import os

import numpy as np
import optax
import pytest

from relativepose_tpu.utils.checkpoint import CheckpointManager as JaxManager
from relativepose_tpu_torch.cli import train_completion, train_feature
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.train import completion as tcomp
from relativepose_tpu_torch.train import feature as tfeat
from relativepose_tpu_torch.utils.checkpoint import restore_params
from test_torch_train_cli import small
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.setenv("RPTPU_SYNTH_CACHE", str(tmp_path / "pairs"))
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("cli", ["feature", "completion"])
def test_cli_resumes_jax_run(workdir, cli):
    """--resume on an experiment directory that the JAX package's CLI
    wrote: an orbax checkpoint_0001/ of a JAX trainer state 5 steps in (its
    layout, with the port's seeded networks).  The port takes the state,
    Adam's count included, and counts on from it and from epoch 1."""
    exp = f"jax_{cli}"
    if cli == "feature":
        state = tfeat.init_state(tfeat.FeatureTrainConfig(base_width=8),
                                 "cpu", seed=3)
        tree, main, extra = {"params": state.params_tree()}, \
            train_feature.main, ()
    else:
        state = tcomp.init_state(tcomp.CompletionTrainConfig(
            ngf=8, base_width=8), "cpu", seed=3)
        tree = {"params": state.params_tree(),
                "net_f_params": convert.flax_params(state.frozen["net_f"])}
        main, extra = train_completion.main, ("--featurelearning", "1")
    adam, empty = optax.adam(2e-4, b1=0.5).init(tree["params"])
    tree.update(opt_state=(adam._replace(count=np.asarray(5, np.int32)),
                           empty), step=np.asarray(5))
    JaxManager(os.path.join("experiments", f"exp_{exp}", "params")).save(
        1, tree)
    ck = main(small("--exp", exp, "--resume", "--device_data", "0", *extra,
                    max_epoch=2))
    assert os.path.basename(ck) == "checkpoint_0002"
    saved = restore_params(os.path.dirname(ck))
    steps = int(saved["step"]) - 5
    assert steps > 0 and int(saved["opt_state"][0]["count"]) == 5 + steps
    with open(os.path.join("experiments", f"exp_{exp}", f"exp_{exp}.log")) \
            as f:
        assert "resume: ok, from epoch 1" in f.read()

