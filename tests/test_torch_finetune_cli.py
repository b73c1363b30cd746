"""cli/finetune_pose.py of relativepose_tpu_torch on the CPU.

The driver pins the full keypoint configuration (344 keypoints, 1720
correspondences) and 30 power iterations, too slow for the CPU in the
tier-1 run: here they are swapped for the small configuration of
`tests/torch_parity.py`, and the driver runs a small SCNet (ngf 8, f32)
for one step on 4 synthetic pairs.  Checked: its flags are the JAX
driver's plus --device; its orbax checkpoint ({'params', 'step'}, as the
JAX driver saves) is read by the JAX package's `restore_params` as a Flax
SCNet tree of the right shapes, bit for bit as the port reads it, and by
the port's evaluation loader; the low-overlap filter keeps the same pairs
as the JAX driver's compiled overlap on the same stored pairs (overlaps to
1e-5: counts of nearest neighbours within 0.08 m, whose squared distances
round otherwise).
"""

import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.core import overlap as joverlap
from relativepose_tpu.eval import harness as jharness
from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.train import finetune_pose as jft
from relativepose_tpu.utils.checkpoint import restore_params as jrestore
from relativepose_tpu_torch.cli import finetune_pose as tcli
from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.data.device_store import DeviceStore
from relativepose_tpu_torch.match.keypoints import KeypointConfig
from relativepose_tpu_torch.match.solver import SolverStaticConfig
from relativepose_tpu_torch.utils.checkpoint import (
    restore_params,
    save_params_npz,
)
from test_torch_orbax import assert_same_tree
from torch_parity import SMALL, flax_scnet_params
from torch_parity import one_torch_thread  # noqa: F401


def test_cli_runs_and_writes_an_npz_both_packages_read(tmp_path,
                                                        monkeypatch):
    params = flax_scnet_params(FlaxSCNet(ngf=8))
    ckpt = save_params_npz(str(tmp_path / "scnet8.npz"), params)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "KeypointConfig",
                        lambda: KeypointConfig(**SMALL))
    monkeypatch.setattr(tcli, "SolverStaticConfig", functools.partial(
        SolverStaticConfig, power_iters=5))
    path = tcli.main(["--exp", "ft", "--rm", "--comp_ckpt", ckpt,
                      "--device", "cpu", "--bf16", "0", "--ngf", "8",
                      "--synthetic_n", "4", "--steps", "1",
                      "--batch_pairs", "2", "--alter_steps", "1",
                      "--log_every", "1"])
    assert path.endswith("checkpoint_0001")
    path = os.path.dirname(path)   # the manager directory, as users pass
    log = (tmp_path / "experiments" / "exp_ft" / "exp_ft.log").read_text()
    losses = [float(line.split()[3]) for line in log.splitlines()
              if line.startswith("step ") and " loss " in line]
    assert len(losses) == 1 and np.isfinite(losses).all()
    state = jrestore(path)
    assert_same_tree(restore_params(path), state)
    assert set(state) == {"params", "step"} and int(state["step"]) == 1
    assert state["step"].dtype == np.int32
    tree = state["params"]
    flat_j = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(flat_j) == set(flat_ref)
    for k, v in flat_ref.items():
        assert np.asarray(flat_j[k]).shape == v.shape
    from relativepose_tpu_torch.cli.evaluate import (
        scnet_fn_factory_from_checkpoint,
    )
    args = argparse.Namespace(
        torch_comp_ckpt=None, comp_ckpt=path, outputType="rgbdnsf",
        snumclass=15, featureDim=32, ngf=8, internal_size="224x224",
        batchnorm=1, skipLayer=1, useTanh=1, bf16=0, device="cpu")
    factory, _ = scnet_fn_factory_from_checkpoint(args, None)
    y = factory(None, None, None)(torch.zeros(1, 2, 160, 640, 16))
    assert y.shape == (1, 2, 160, 640, 54) and bool(torch.isfinite(y).all())


def test_orbax_directory_raises(tmp_path):
    """A manager directory with no checkpoint in it (reading one:
    tests/test_torch_orbax.py)."""
    with pytest.raises(FileNotFoundError, match="no orbax checkpoint"):
        tcli.main(["--exp", "x", "--rm", "--comp_ckpt", str(tmp_path),
                   "--device", "cpu"])


def test_overlap_filter_matches_jax_driver():
    """The kept pairs of `pair_overlaps` equal those of the JAX driver's
    jitted overlap (its cli/finetune_pose.py, batches of 64) on the same
    stored pairs (the CLI test's first 2)."""
    src = dsets.SyntheticPairs("suncg", n=2, seed=0, view_detail_jitter=True)
    store = DeviceStore(src, device="cpu")
    ovs_t = tcli.pair_overlaps(store, "suncg")

    arrays = {k: v.numpy() for k, v in store.arrays.items()}
    arrays["depth"] = arrays["depth"].view(np.uint16)
    arrays = {k: jnp.asarray(v) for k, v in arrays.items()}

    @jax.jit
    def pair_overlap(arrays, idx):
        ds, dt, T_gt = jft.gather_eval_pairs(arrays, idx)

        def one(d_s, d_t, T):
            pc_s, val_s, _ = jharness.parse_eval_data(
                d_s["depth"], d_s["rgb"], d_s["norm"], "suncg", "ours")
            pc_t, val_t, _ = jharness.parse_eval_data(
                d_t["depth"], d_t["rgb"], d_t["norm"], "suncg", "ours")
            return joverlap.point_cloud_overlap(
                pc_s, val_s, pc_t, val_t, T)["overlap"]

        return jax.vmap(one)(ds, dt, T_gt)

    ovs_j = np.asarray(pair_overlap(arrays, jnp.arange(2, dtype=jnp.int32)))
    np.testing.assert_allclose(ovs_t, ovs_j, atol=1e-5)
    keep_t = np.where(ovs_t <= 0.55)[0]
    np.testing.assert_array_equal(keep_t, np.where(ovs_j <= 0.55)[0])
    assert len(keep_t) > 0


def test_cli_flags_match_the_jax_driver(monkeypatch):
    """The JAX driver's flags, plus --device."""
    from relativepose_tpu.cli import finetune_pose as jcli
    seen = []

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        seen.append({a.dest for a in self._actions})
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for m in (jcli, tcli):
        with pytest.raises(Parsed):
            m.main([])
    assert seen[1] == seen[0] | {"device"}
