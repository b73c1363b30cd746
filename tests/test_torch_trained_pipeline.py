"""One recurrence step of the port with the shipped trained completion
net against the JAX package's, on the CPU.

`relativepose_tpu/data/pretrained/suncg.comp.npz` (SCNet at ngf 64, the
net the evaluation CLIs load with `--comp_ckpt`) is read once for the
module and converted in memory (`models/convert.py`); both packages run
one step of `estimate_pose_via_completion` from the identity on one
synthetic suncg pair, in f32, at the small keypoint configuration of
`__graft_entry__.py` (n_detect=32, n_match=16, n_random=8, power_iters=5),
the port on the JAX package's keypoint draws (`tests/torch_parity.py`).
Spies on each package's SCNet function and `build_keypoint_sets` catch
the completed panos and the keypoint picks.  Measured on an 8-core CPU
(torch on one thread): the panos 3.2e-5 relative L2 apart,
median 1.1e-5, max 6.5e-3 on outputs up to 11.2; every keypoint pick the
same (80 per view, 70 and 80 of them valid); the poses 5.5e-4 apart,
both 17.4 degrees from the ground truth after this one step.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.match import keypoints as jkp
from relativepose_tpu.match.solver import SolverHyperParams as JHyper
from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.pipeline import recurrent as jrec
from relativepose_tpu_torch.match import keypoints as tkp
from relativepose_tpu_torch.match.solver import SolverHyperParams
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.pipeline import recurrent as trec
from relativepose_tpu_torch.utils.checkpoint import load_params_npz
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (
    configs,
    jax_detection_mask,
    jax_pipeline_draws,
    pairs,
)

WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "relativepose_tpu",
                       "data", "pretrained", "suncg.comp.npz")


def spy(monkeypatch, module, name, into):
    """Replace module.name by a wrapper that appends its outputs to
    `into`."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        into.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def one_step():
    """Both packages' step on pair 30 -> dict of numpy results."""
    params = load_params_npz(WEIGHTS)
    ds, dt, T_gt = pairs([30])
    jcfg, tcfg = (dataclasses.replace(c, alter_steps=1)
                  for c in configs(unroll=True))
    fnet = FlaxSCNet(ngf=64)
    jparams = jax.tree.map(jnp.asarray, params)
    apply = jax.jit(lambda x: fnet.apply({"params": jparams}, x))
    key = jax.random.split(jax.random.PRNGKey(5), 1)
    dj = {k: jnp.asarray(v[0]) for k, v in ds.items()}
    dtj = {k: jnp.asarray(v[0]) for k, v in dt.items()}
    jout, jpicks, tout, tpicks = [], [], [], []
    with pytest.MonkeyPatch.context() as mp:
        spy(mp, jkp, "build_keypoint_sets", jpicks)

        def jscnet(x):
            y = apply(x)
            jout.append(y)
            return y

        Tj = jrec.estimate_pose_via_completion(jscnet, dj, dtj, key[0],
                                               JHyper(), jcfg)
    draws = jax_pipeline_draws(key, 1, jax_detection_mask(dj, jcfg)[None],
                               jax_detection_mask(dtj, jcfg)[None],
                               jcfg.keypoints)
    net = convert.load_flax_params(SCNet(ngf=64), params).eval()
    scnet_fn = trec.make_scnet_fn(net)
    with pytest.MonkeyPatch.context() as mp:
        spy(mp, tkp, "build_keypoint_sets", tpicks)

        def tscnet(x):
            y = scnet_fn(x)
            tout.append(y)
            return y

        with torch.no_grad():
            Tt = trec.estimate_pose_via_completion(
                tscnet, ds, dt, SolverHyperParams(), tcfg, draws=draws,
                device="cpu")
    return dict(
        T_gt=T_gt[0], Tj=np.asarray(Tj), Tt=Tt[0].numpy(),
        yj=np.asarray(jout[0]), yt=tout[0][0].numpy(),
        pj=[np.asarray(a) for a in jpicks[0]],
        pt=[a[0].numpy() for a in tpicks[0]])


def test_completed_panos_match(one_step):
    """The completed panos of both views, to the bounds of
    `test_torch_scnet.py::test_shipped_comp_weights_forward_matches_flax`
    (relative L2 2e-4, median |difference| 1e-4) on the input that the
    step built from the identity."""
    yj, yt = one_step["yj"], one_step["yt"]
    assert yt.shape == yj.shape == (2, 160, 640, 54)
    assert np.isfinite(yt).all()
    assert np.linalg.norm(yt - yj) <= 2e-4 * np.linalg.norm(yj)
    assert np.median(np.abs(yt - yj)) <= 1e-4


def test_keypoint_picks_match(one_step):
    """The keypoint sets built on the completed panos: validity and
    weights exactly, and every position exactly but at most one per view,
    a heatmap near tie: the descriptors are sampled from panos that
    differ by the f32 rounding above, and a query whose two best source
    pixels are that close may pick the other one
    (`test_torch_sigma_tune.py` found such a pair).  None differs here."""
    pj, pt = one_step["pj"], one_step["pt"]
    for side in (0, 3):
        pos_j, valid_j, w_j = pj[side:side + 3]
        pos_t, valid_t, w_t = pt[side:side + 3]
        assert pos_t.shape == pos_j.shape == (80, 2)
        np.testing.assert_array_equal(valid_t, valid_j)
        np.testing.assert_array_equal(w_t, w_j)
        off = np.abs(pos_t - pos_j).max(-1) > 0
        assert off.sum() <= 1, np.nonzero(off)


def test_step_pose_matches(one_step):
    """The step's pose in both packages, to 2e-3 (measured 5.5e-4): the
    same picks, lifted through depths and normals and described by
    features that differ by the panos' rounding, through the solver."""
    Tt, Tj = one_step["Tt"], one_step["Tj"]
    assert not np.allclose(Tt, np.eye(4))
    np.testing.assert_allclose(Tt, Tj, atol=2e-3)
