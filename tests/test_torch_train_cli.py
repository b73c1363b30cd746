"""The port's training CLIs on the CPU, and their npz checkpoints across
both packages.

Both drivers run at a small size (`--device cpu --bf16 0 --ngf 8
--base_width 8 --debug --max_epoch 1 --train_duration 2`, 2 pairs per
batch) on the synthetic debug set, rendered once for the module.  A
checkpoint the port saves loads into the JAX package's `load_params_npz`
and Flax modules, and one the JAX package saves loads into the port; the
outputs of both packages on the loaded weights agree within 1e-4 (f32
sums in another order; the f16 weights are the same on both sides).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.models import Resnet18_8s as FlaxResnet
from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.train import feature as jfeat
from relativepose_tpu.utils.checkpoint import load_params_npz as jload
from relativepose_tpu.utils.checkpoint import save_params_npz as jsave
from relativepose_tpu_torch.cli import train_completion, train_feature
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.resnet import Resnet18_8s
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.utils.checkpoint import load_params_npz

TOL = 1e-4
SMALL = ["--device", "cpu", "--bf16", "0", "--ngf", "8", "--base_width",
         "8", "--debug", "--train_duration", "2", "--batch_size", "2",
         "--dataList", "synthetic"]


def small(*extra, max_epoch=1):
    return SMALL + ["--max_epoch", str(max_epoch)] + list(extra)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory whose synthetic pairs are rendered once."""
    root = tmp_path_factory.mktemp("train_cli")
    old_env = os.environ.get("RPTPU_SYNTH_CACHE")
    os.environ["RPTPU_SYNTH_CACHE"] = str(root / "pairs")
    cwd = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(cwd)
    if old_env is None:
        os.environ.pop("RPTPU_SYNTH_CACHE", None)
    else:
        os.environ["RPTPU_SYNTH_CACHE"] = old_env


@pytest.fixture(scope="module")
def feat_ckpt(workdir):
    return train_feature.main(small("--exp", "feat", "--rm"))


@pytest.fixture(scope="module")
def comp_ckpt(feat_ckpt):
    return train_completion.main(small("--exp", "comp", "--rm",
                                       "--featurelearning", "1",
                                       "--feat_ckpt", feat_ckpt))


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
    assert os.path.basename(feat_ckpt) == "checkpoint_0001.npz"
    assert os.path.exists(feat_ckpt.replace(".npz", ".resume.npz"))
    tree = jload(feat_ckpt)
    assert set(tree) == {"net_f", "seg"}
    assert_finite_log(feat_ckpt)


def test_feature_cli_resumes(feat_ckpt):
    """--resume restores parameters, Adam and the step, and numbers the
    next checkpoint after the last."""
    with np.load(feat_ckpt.replace(".npz", ".resume.npz")) as z:
        step0 = int(z["step"])
    ck2 = train_feature.main(small("--exp", "feat", "--resume",
                                   max_epoch=2))
    assert os.path.basename(ck2) == "checkpoint_0002.npz"
    with np.load(ck2.replace(".npz", ".resume.npz")) as z:
        assert int(z["step"]) > step0
    with open(os.path.join(os.path.dirname(os.path.dirname(ck2)),
                           "exp_feat.log")) as f:
        assert "resume: ok, from epoch 1" in f.read()


def test_completion_cli_with_feature_checkpoint(comp_ckpt):
    tree = jload(comp_ckpt)
    assert "ConvBlock_0" in tree and "net_f" not in tree
    assert_finite_log(comp_ckpt)
    rows = logged(comp_ckpt)
    assert any("val_loss_fc" in r["values"] for r in rows)


def test_port_checkpoints_load_in_jax(feat_ckpt, comp_ckpt, rng):
    """The port's feature and completion npz through the JAX package's
    loader and Flax modules."""
    x = rng.randn(2, 160, 640, 7).astype(np.float32)
    net = convert.load_flax_params(Resnet18_8s(base_width=8),
                                   load_params_npz(feat_ckpt)["net_f"])
    yj = FlaxResnet(base_width=8).apply({"params": jload(feat_ckpt)["net_f"]},
                                        jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(),
                                   np.asarray(yj), atol=TOL)
    x16 = rng.randn(2, 160, 640, 16).astype(np.float32)
    scnet = convert.load_flax_params(SCNet(ngf=8),
                                     load_params_npz(comp_ckpt))
    yj = FlaxSCNet(ngf=8).apply({"params": jload(comp_ckpt)},
                                jnp.asarray(x16))
    with torch.no_grad():
        np.testing.assert_allclose(scnet(torch.from_numpy(x16)).numpy(),
                                   np.asarray(yj), atol=TOL)


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
    ["--feat_ckpt", "experiments/exp_feat/params"],
    ["--feat_ckpt", "params_dir", "--num_devices", "2", "--model_parallel",
     "2"],
])
def test_unported_options_raise(workdir, extra):
    """Orbax checkpoint directories are the one input the port does not
    read; a multi-rank run refuses one before any rank starts."""
    with pytest.raises(NotImplementedError, match="save_params_npz"):
        train_completion.main(small("--exp", "unported", "--rm", *extra))
