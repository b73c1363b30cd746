"""The original repository's checkpoints in the port
(`relativepose_tpu_torch/utils/torch_import.py`), on the CPU.

Reference-format state dicts come from the torch oracles of
`tests/test_torch_import.py` (`_TorchResnet18_8s`, `_TorchSCNet`,
`_randomize`; imported, not copied) at ngf 16 and base width 16.  The
port's networks, loaded through its importer, must give the oracle's
forward and the JAX package's imported Flax forward to 1e-4.  The SCNet
input is 224x224, SCNet's internal size, so no resize stands between the
oracle (F.interpolate) and the port (the JAX package's interpolation
matrices); the feature net upsamples its score maps, where the two
resizes differ, so it is held to 1e-4 of its output's largest magnitude,
as the JAX package's own test holds the Flax net.  Then both CLIs read a
`.pth.tar` with `module.` prefixes under `state_dict`."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.models import Resnet18_8s as FlaxResnet
from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.utils import torch_import as jti
from relativepose_tpu_torch.cli import evaluate, train_completion
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.resnet import Resnet18_8s
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.utils import torch_import as tti
from test_torch_import import _randomize, _TorchResnet18_8s, _TorchSCNet

NGF, WIDTH = 16, 16


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _save_reference(module, path):
    torch.save({"epoch": 3, "state_dict": {
        f"module.{k}": v for k, v in module.state_dict().items()}},
        str(path))
    return str(path)


@pytest.fixture(scope="module")
def oracle_scnet():
    tm = _TorchSCNet(output_type="rgbdnsf", snumclass=15, feature_dim=32,
                     ngf=NGF)
    _randomize(tm, 4)
    return tm


@pytest.fixture(scope="module")
def oracle_resnet():
    tm = _TorchResnet18_8s(num_input=7, w=WIDTH, use_tanh=False)
    _randomize(tm, 0)
    return tm.eval()


def test_trees_equal_the_jax_importer(oracle_scnet, oracle_resnet):
    """The port's numpy map gives the JAX package's tree, leaf for leaf."""
    pairs = [(tti.import_scnet(_sd(oracle_scnet)),
              jti.import_scnet(_sd(oracle_scnet))),
             (tti.import_resnet18_8s(_sd(oracle_resnet)),
              jti.import_resnet18_8s(_sd(oracle_resnet)))]
    for a, b in pairs:
        fa, fb = convert.flatten_params(a), convert.flatten_params(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert tti.scnet_name_map("rgbdnf") == jti.scnet_name_map("rgbdnf")


def test_scnet_matches_oracle_and_flax(oracle_scnet):
    x = np.random.default_rng(5).normal(
        size=(2, 16, 224, 224)).astype(np.float32)
    with torch.no_grad():
        ref = oracle_scnet(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    net = tti.load_scnet(_sd(oracle_scnet), SCNet(ngf=NGF))
    # the tree's scale = weight - 1 comes back as the multiplier
    bn = oracle_scnet.conv1rgb[1].weight.detach()
    assert float((net.convs[0].bn.weight.detach() - bn).abs().max()) < 1e-6
    xh = x.transpose(0, 2, 3, 1)
    with torch.no_grad():
        out = net(torch.from_numpy(xh)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    flax = FlaxSCNet(ngf=NGF).apply(
        {"params": jax.tree.map(jnp.asarray,
                                jti.import_scnet(_sd(oracle_scnet)))},
        jnp.asarray(xh))
    np.testing.assert_allclose(out, np.asarray(flax), atol=1e-4)


def test_resnet_matches_oracle_and_flax(oracle_resnet):
    x = np.random.default_rng(1).normal(
        size=(2, 7, 32, 64)).astype(np.float32)
    with torch.no_grad():
        ref = oracle_resnet(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    net = tti.load_resnet18_8s(
        _sd(oracle_resnet), Resnet18_8s(base_width=WIDTH, frozen_bn=True,
                                        use_tanh=False))
    xh = x.transpose(0, 2, 3, 1)
    with torch.no_grad():
        out = net(torch.from_numpy(xh)).numpy()
    flax = np.asarray(FlaxResnet(num_input=7, base_width=WIDTH,
                                 frozen_bn=True, use_tanh=False).apply(
        {"params": jax.tree.map(jnp.asarray,
                                jti.import_resnet18_8s(_sd(oracle_resnet)))},
        jnp.asarray(xh)))
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, atol=1e-4 * scale)
    np.testing.assert_allclose(out, flax, atol=1e-4 * scale)


def test_import_checks_shapes_and_frozen_bn(oracle_resnet, oracle_scnet):
    with pytest.raises(ValueError, match="frozen_bn"):
        tti.load_resnet18_8s(_sd(oracle_resnet),
                             Resnet18_8s(base_width=WIDTH))
    with pytest.raises(ValueError, match="shape mismatch"):
        tti.load_scnet(_sd(oracle_scnet), SCNet(ngf=8))


def test_evaluate_cli_reads_a_reference_checkpoint(tmp_path, monkeypatch,
                                                   oracle_scnet):
    monkeypatch.chdir(tmp_path)
    ck = _save_reference(oracle_scnet, tmp_path / "suncg.comp.pth.tar")
    runner = evaluate.main([
        "--dataList", "synthetic", "--synthetic_family", "suncg",
        "--method", "ours_nr", "--maxIter", "1", "--batch_pairs", "1",
        "--torch_comp_ckpt", ck, "--ngf", str(NGF), "--n_detect", "32",
        "--exp", "torch_ck", "--rm", "--bf16", "0", "--device", "cpu"])
    assert len(runner.error_stats) == 1
    for r in runner.error_stats:
        assert np.isfinite(float(r["err_ad"]))
        R = np.asarray(r["T_hat"])[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_train_completion_cli_reads_a_reference_feature_net(
        tmp_path, monkeypatch, oracle_resnet):
    """--torch_feat_ckpt: the frozen netF with folded running statistics
    (streamed pairs, so only the batches it takes are rendered)."""
    monkeypatch.chdir(tmp_path)
    ck = _save_reference(oracle_resnet, tmp_path / "suncg.feat.pth.tar")
    path = train_completion.main([
        "--device", "cpu", "--bf16", "0", "--ngf", "8", "--base_width",
        str(WIDTH), "--debug", "--train_duration", "1", "--batch_size", "2",
        "--dataList", "synthetic", "--max_epoch", "1", "--device_data", "0",
        "--featurelearning", "1", "--torch_feat_ckpt", ck, "--exp", "tf",
        "--rm"])
    assert path.endswith(".npz")
    log = (tmp_path / "experiments/exp_tf/exp_tf.log").read_text()
    assert "loaded frozen netF weights" in log
    import json
    rows = [json.loads(r) for r in (
        tmp_path / "experiments/exp_tf/tensorboard/scalars.jsonl"
    ).read_text().splitlines()]
    assert rows and all(math.isfinite(v) for r in rows
                        for v in r["values"].values())
