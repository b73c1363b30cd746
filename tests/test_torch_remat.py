"""Pose fine-tuning of relativepose_tpu_torch through the pipeline, checks
of the port alone on the CPU (the parity with the JAX package is
`tests/test_torch_finetune.py`).

  * remat=True and remat=False give bit-equal losses and gradients over
    two recurrence steps, finite and not all zero: the counterpart of the
    JAX package's `test_pipeline_backward_is_finite`, which is `slow`
    there;
  * the recompute of a rematerialised step draws nothing;
  * the anchor term.
The small pipeline of `tests/torch_parity.py` with an f32 SCNet at ngf 8
from a fixed torch seed, on two synthetic suncg pairs.
"""

import numpy as np
import torch

from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.pipeline import recurrent as trec
from relativepose_tpu_torch.train import finetune_pose as tft
from test_torch_finetune import pipe_configs, sigma_tables
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import pairs


def small_pairs():
    ds, dt, T_gt = pairs([5, 6])
    return (trec.as_pair_batch(ds, "cpu"), trec.as_pair_batch(dt, "cpu"),
            torch.from_numpy(T_gt.astype(np.float32)))


def loss_and_grads(net, cfg, hp, data, **kw):
    ft = tft.PoseFinetuneConfig(ngf=8)
    loss, _ = tft.loss_fn(net, None, *data, cfg, hp, ft, **kw)
    grads = torch.autograd.grad(loss, list(net.parameters()),
                                allow_unused=True)
    return loss.detach(), [g for g in grads if g is not None]


def test_remat_equals_no_remat_and_is_finite():
    """Two recurrence steps, gradients through both: rematerialised steps
    give the loss and every gradient of the plain run bit for bit, and
    the gradients are finite and not all zero."""
    torch.manual_seed(0)
    net = SCNet(ngf=8)
    data = small_pairs()
    _, hp = sigma_tables(2)
    out = {}
    for remat in (True, False):
        _, cfg = pipe_configs(2, remat)
        out[remat] = loss_and_grads(
            net, cfg, hp, data,
            generator=torch.Generator().manual_seed(11))
    (l1, g1), (l0, g0) = out[True], out[False]
    assert float(l1) == float(l0) and np.isfinite(float(l1))
    assert len(g1) == len(g0) > 0
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert bool(torch.isfinite(a).all())
    assert max(float(g.abs().max()) for g in g1) > 0


def test_remat_recompute_draws_nothing(monkeypatch):
    """With remat the keypoint draws are made once, before the first step:
    the backward (which recomputes every step) calls `draw_keypoints` no
    more and leaves the generator's state as the forward left it."""
    calls = []
    draw = trec.draw_keypoints

    def counted(*a, **kw):
        calls.append(1)
        return draw(*a, **kw)

    monkeypatch.setattr(trec, "draw_keypoints", counted)
    torch.manual_seed(0)
    net = SCNet(ngf=8)
    _, cfg = pipe_configs(2, remat=True)
    _, hp = sigma_tables(2)
    gen = torch.Generator().manual_seed(11)
    ft = tft.PoseFinetuneConfig(ngf=8)
    loss, _ = tft.loss_fn(net, None, *small_pairs(), cfg, hp, ft,
                          generator=gen)
    after_forward = gen.get_state().clone()
    assert len(calls) == 2
    loss.backward()
    assert len(calls) == 2
    assert torch.equal(gen.get_state(), after_forward)


def test_anchor_term():
    """anchor_weight > 0: the anchor is the starting parameters, its L2
    is 0 at the first step and sum((p - p0)^2) at the second, and the
    loss is the pose loss plus anchor_weight times it."""
    torch.manual_seed(0)
    net = SCNet(ngf=8)
    p0 = [p.detach().clone() for p in net.parameters()]
    ft = tft.PoseFinetuneConfig(ngf=8, anchor_weight=0.5, learning_rate=1e-3)
    state = tft.init_state(net, ft)
    _, cfg = pipe_configs(1)
    _, hp = sigma_tables(1)
    step = tft.make_finetune_step(cfg, hp, ft)
    data = small_pairs()
    gen = torch.Generator().manual_seed(2)
    m1 = step(state, *data, generator=gen)
    assert float(m1["anchor_l2"]) == 0.0
    expect = float(sum(torch.sum((p.detach() - a) ** 2)
                       for p, a in zip(net.parameters(), p0)))
    m2 = step(state, *data, generator=gen)
    assert expect > 0
    np.testing.assert_allclose(float(m2["anchor_l2"]), expect, rtol=1e-5)
    pose = ft.rot_weight * float(m2["rot_frob2"]) + \
        ft.trans_weight * float(m2["trans_se"])
    np.testing.assert_allclose(float(m2["loss"]), pose + 0.5 * expect,
                               rtol=1e-5)


def test_remat_steps_run_cudnn_deterministically():
    """A rematerialised step, in the forward and in its recompute, runs
    with cuDNN held to deterministic algorithms (on the card f32
    convolutions otherwise differ between calls, and the recompute must
    repeat the forward); the caller's setting is restored after, and a
    step without remat keeps it."""
    torch.manual_seed(0)
    net = SCNet(ngf=8)
    seen = []

    def scnet_fn(x):
        seen.append(torch.backends.cudnn.deterministic)
        return trec.make_scnet_fn(net)(x)

    _, hp = sigma_tables(2)
    prev = torch.backends.cudnn.deterministic
    for remat in (True, False):
        _, cfg = pipe_configs(2, remat)
        seen.clear()
        T = trec.estimate_pose_via_completion(
            scnet_fn, *small_pairs()[:2], hp, cfg,
            generator=torch.Generator().manual_seed(1), device="cpu")
        T.sum().backward()
        assert torch.backends.cudnn.deterministic == prev
        assert seen == ([True] * 4 if remat else [prev] * 2), seen
