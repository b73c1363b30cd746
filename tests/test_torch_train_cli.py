"""The port's training CLIs on the CPU, and their checkpoints across both
packages.

Both drivers run at a small size (`--device cpu --bf16 0 --ngf 8
--base_width 8 --debug --max_epoch 1 --train_duration 2`, 2 pairs per
batch) on the synthetic debug set, rendered once for the module.  The
trainer's clock is `OneStepClock`: each time-boxed phase takes one
step, so the checkpoints are the same on any machine.  The
orbax checkpoint the port saves (`experiments/exp_<name>/params/
checkpoint_%04d/`) loads into the JAX package's `restore_params` and Flax
modules, and an npz the JAX package saves loads into the port; the
outputs of both packages on the loaded weights agree within 1e-4 (f32
sums in another order; the weights are the same on both sides), SCNet's
each within 1e-4 of its f64 evaluation.
"""

import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.models import Resnet18_8s as FlaxResnet
from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.train import feature as jfeat
from relativepose_tpu.utils.checkpoint import load_params_npz as jload
from relativepose_tpu.utils.checkpoint import restore_params as jrestore
from relativepose_tpu.utils.checkpoint import save_params_npz as jsave
from relativepose_tpu_torch.cli import train_completion, train_feature
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.resnet import Resnet18_8s
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.utils import orbax_read, trainer
from relativepose_tpu_torch.utils.checkpoint import (
    load_params_npz,
    restore_params,
)
from test_torch_orbax import assert_same_tree
from torch_parity import flax_f64
from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-4
SMALL = ["--device", "cpu", "--bf16", "0", "--ngf", "8", "--base_width",
         "8", "--debug", "--train_duration", "2", "--batch_size", "2",
         "--dataList", "synthetic"]


def small(*extra, max_epoch=1):
    return SMALL + ["--max_epoch", str(max_epoch)] + list(extra)


class OneStepClock:
    """`time.time` of `utils/trainer.py` in this module: every time-boxed
    phase takes one step, whatever its budget and however fast the
    machine.  A phase reads the clock at its start and before each step;
    here the first reading after the start is 1 ms later, the second
    1e5 s later.

    On the wall clock the step count, and so the weights, depended on the
    machine's speed, and so did the outcome of the SCNet comparison of
    `test_port_checkpoints_load_in_jax` while it held the two packages'
    outputs to each other: with `--train_duration 8` (5 feature and 3
    completion steps) 1 of 11,059,200 values was 1.18e-4 apart, against
    1e-4, though each package was within 6.7e-5 (the port) and 5.1e-5
    (the JAX package) of the f64 evaluation."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        phase, k = divmod(self.n, 3)   # start, one step, stop
        self.n += 1
        return phase * 1e6 + (0.0, 1e-3, 1e5)[k]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory whose synthetic pairs are rendered once, with
    the trainer on `OneStepClock`."""
    root = tmp_path_factory.mktemp("train_cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RPTPU_SYNTH_CACHE", str(root / "pairs"))
        mp.chdir(root)
        mp.setattr(trainer, "time",
                   types.SimpleNamespace(time=OneStepClock()))
        yield root


@pytest.fixture(scope="module")
def feat_ckpt(workdir):
    return train_feature.main(small("--exp", "feat", "--rm"))


@pytest.fixture(scope="module")
def comp_ckpt(feat_ckpt):
    return train_completion.main(small("--exp", "comp", "--rm",
                                       "--featurelearning", "1",
                                       "--feat_ckpt",
                                       os.path.dirname(feat_ckpt)))


def logged(ckpt):
    exp = os.path.dirname(os.path.dirname(ckpt))
    with open(os.path.join(exp, "tensorboard", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def assert_finite_log(ckpt):
    rows = logged(ckpt)
    assert rows and any("val_loss" in r["values"] for r in rows)
    for r in rows:
        assert all(math.isfinite(v) for v in r["values"].values()), r


def test_feature_cli_writes_checkpoint(feat_ckpt):
    """The orbax checkpoint_0001/ of the JAX feature CLI's state tree, and
    nothing else, in experiments/exp_feat/params."""
    assert os.path.basename(feat_ckpt) == "checkpoint_0001"
    assert orbax_read.is_checkpoint(feat_ckpt)
    assert os.listdir(os.path.dirname(feat_ckpt)) == ["checkpoint_0001"]
    tree = jrestore(os.path.dirname(feat_ckpt))
    assert set(tree) == {"params", "opt_state", "step"}
    assert set(tree["params"]) == {"net_f", "seg"}
    assert int(tree["step"]) == int(tree["opt_state"][0]["count"]) > 0
    assert_finite_log(feat_ckpt)


def test_feature_cli_resumes(feat_ckpt):
    """--resume restores parameters, Adam and the step, and numbers the
    next checkpoint after the last."""
    params = os.path.dirname(feat_ckpt)
    step0 = int(restore_params(params)["step"])
    ck2 = train_feature.main(small("--exp", "feat", "--resume",
                                   max_epoch=2))
    assert os.path.basename(ck2) == "checkpoint_0002"
    tree = jrestore(params)
    assert int(tree["step"]) == int(tree["opt_state"][0]["count"]) > step0
    with open(os.path.join(os.path.dirname(os.path.dirname(ck2)),
                           "exp_feat.log")) as f:
        assert "resume: ok, from epoch 1" in f.read()


def test_completion_cli_with_feature_checkpoint(comp_ckpt):
    state = jrestore(os.path.dirname(comp_ckpt))
    assert set(state) == {"params", "net_f_params", "opt_state", "step"}
    tree = state["params"]
    assert "ConvBlock_0" in tree and "net_f" not in tree
    assert_finite_log(comp_ckpt)
    rows = logged(comp_ckpt)
    assert any("val_loss_fc" in r["values"] for r in rows)


def test_port_checkpoints_load_in_jax(feat_ckpt, comp_ckpt, rng):
    """The port's feature and completion checkpoints through the JAX
    package's `restore_params` (every leaf bit for bit as the port reads
    it) and Flax modules.  Resnet18_8s's outputs agree within TOL.
    SCNet's are each held within TOL of the f64 evaluation of the same
    weights (`torch_parity.flax_f64`), as `tests/test_torch_scnet.py`
    bounds each package's f32 error: its 1x1 bottleneck's BatchNorm
    normalises 2 values per channel and amplifies each package's f32
    rounding, in either direction.  On this module's
    weights the port's f32 output is 6.0e-5 from the f64 one at most and
    the JAX package's 6.4e-5, the two 1.2e-4 apart (11 of 11,059,200
    values over 1e-4)."""
    feat, comp = os.path.dirname(feat_ckpt), os.path.dirname(comp_ckpt)
    for d in (feat, comp):
        assert_same_tree(restore_params(d), jrestore(d))
    x = rng.randn(2, 160, 640, 7).astype(np.float32)
    net = convert.load_flax_params(Resnet18_8s(base_width=8),
                                   restore_params(feat)["params"]["net_f"])
    yj = FlaxResnet(base_width=8).apply(
        {"params": jrestore(feat)["params"]["net_f"]}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(),
                                   np.asarray(yj), atol=TOL)
    x16 = rng.randn(2, 160, 640, 16).astype(np.float32)
    scnet = convert.load_flax_params(SCNet(ngf=8),
                                     restore_params(comp)["params"])
    yj = FlaxSCNet(ngf=8).apply({"params": jrestore(comp)["params"]},
                                jnp.asarray(x16))
    y64 = flax_f64(FlaxSCNet(ngf=8), jrestore(comp)["params"], x16)
    with torch.no_grad():
        np.testing.assert_allclose(scnet(torch.from_numpy(x16)).numpy(),
                                   y64, atol=TOL)
    np.testing.assert_allclose(np.asarray(yj), y64, atol=TOL)


def test_jax_checkpoint_trains_port_completion(workdir, rng):
    """An npz the JAX package saves (its feature state's params) is the
    port's frozen netF, with the same outputs."""
    params = jfeat.init_state(jax.random.PRNGKey(3),
                              jfeat.FeatureTrainConfig(base_width=8))[
        "params"]
    path = jsave(str(workdir / "jax_feat.npz"), params)
    x = rng.randn(2, 160, 640, 7).astype(np.float32)
    yj = FlaxResnet(base_width=8).apply({"params": jload(path)["net_f"]},
                                        jnp.asarray(x))
    net = convert.load_flax_params(Resnet18_8s(base_width=8),
                                   load_params_npz(path)["net_f"])
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(),
                                   np.asarray(yj), atol=TOL)
    ckpt = train_completion.main(small("--exp", "comp_jaxf", "--rm",
                                       "--featurelearning", "1",
                                       "--feat_ckpt", path))
    assert_finite_log(ckpt)


@pytest.mark.parametrize("extra", [
    ["--feat_ckpt", "params_dir"],
    ["--feat_ckpt", "params_dir", "--num_devices", "2"],
    ["--feat_ckpt", "experiments/exp_feat"],
    ["--feat_ckpt", "params_dir", "--num_devices", "2", "--model_parallel",
     "2"],
])
def test_unported_options_raise(workdir, extra):
    """A --feat_ckpt that is neither an npz file nor a manager directory
    with a checkpoint (here a missing path, or the experiment directory
    above the params one) raises FileNotFoundError; a multi-rank run
    refuses it before any rank starts."""
    with pytest.raises(FileNotFoundError, match="neither an npz"):
        train_completion.main(small("--exp", "unported", "--rm", *extra))
