"""Both training CLIs on two gloo ranks on the CPU (`--num_devices 2
--device cpu`), streaming the synthetic pairs so that only the batches
taken are rendered: each writes one orbax checkpoint, from rank 0, with
the full parameter shapes and Adam moments, and logs finite losses."""

import json
import math
import os

import numpy as np

from relativepose_tpu_torch.cli import train_completion, train_feature
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.resnet import Resnet18_8s
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.utils.checkpoint import restore_params

SMALL = ["--device", "cpu", "--bf16", "0", "--debug", "--train_duration",
         "1", "--batch_size", "2", "--dataList", "synthetic", "--max_epoch",
         "1", "--device_data", "0", "--num_devices", "2", "--rm"]


def _finite_log(ckpt):
    exp = os.path.dirname(os.path.dirname(ckpt))
    with open(os.path.join(exp, "tensorboard", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows
    for r in rows:
        assert all(math.isfinite(v) for v in r["values"].values()), r
    assert sorted(os.listdir(os.path.dirname(ckpt))) == ["checkpoint_0001"]


def test_two_rank_training_clis(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # data parallel: one pair per rank
    feat = train_feature.main(SMALL + ["--exp", "f", "--base_width", "8"])
    _finite_log(feat)
    convert.load_flax_params(Resnet18_8s(base_width=8), restore_params(
        os.path.dirname(feat))["params"]["net_f"])
    # model parallel: SCNet's 256-channel bottleneck split over 2 ranks;
    # the checkpoint holds the whole kernel
    comp = train_completion.main(SMALL + [
        "--exp", "c", "--ngf", "16", "--base_width", "8",
        "--model_parallel", "2", "--featurelearning", "1", "--feat_ckpt",
        os.path.dirname(feat)])
    _finite_log(comp)
    state = restore_params(os.path.dirname(comp))
    tree = state["params"]
    for t in (tree, state["opt_state"][0]["mu"], state["opt_state"][0]["nu"]):
        assert np.shape(t["ConvBlock_14"]["Conv_0"]["kernel"])[-1] == 256
    convert.load_flax_params(SCNet(ngf=16), tree)
