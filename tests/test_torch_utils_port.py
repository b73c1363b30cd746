"""The port's host utilities: profiling, and its copies of img, plot and
visualization against the JAX package's, on the same inputs."""

import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from relativepose_tpu.utils import img as jimg
from relativepose_tpu.utils import plot as jplot
from relativepose_tpu.utils import visualization as jvis
from relativepose_tpu_torch.utils import img as timg
from relativepose_tpu_torch.utils import plot as tplot
from relativepose_tpu_torch.utils import profiling
from relativepose_tpu_torch.utils import visualization as tvis
from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_stage_timer_synchronises_the_tensors_devices(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    on_card = mock.Mock(spec=torch.Tensor)
    on_card.device = torch.device("cuda", 1)
    timer = profiling.StageTimer()
    with timer.stage("a", block_on={"x": [on_card, torch.zeros(2)]}):
        pass
    with timer.stage("a", block_on=torch.zeros(2)):
        pass
    assert calls == [torch.device("cuda", 1)]
    rep = timer.report()
    assert set(rep) == {"a"} and rep["a"] >= 0
    assert timer.meters["a"].count == 2


def test_debug_nans_raises_at_the_op_that_makes_the_nan():
    x = torch.tensor([1.0, -1.0])
    profiling.debug_nans(True)
    try:
        torch.exp(x)   # finite: no error
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
        # a NaN made in the backward only: sqrt's gradient at 0 is the
        # incoming 0 divided by 2 sqrt(0)
        z = torch.zeros(1, requires_grad=True)
        y = (torch.sqrt(z) * 0.0).sum()
        with pytest.raises(FloatingPointError, match="div"):
            y.backward()
    finally:
        profiling.debug_nans(False)
    assert torch.isnan(torch.log(x)).any()   # off again


def test_img_matches_jax():
    for args in ((np.array([30.0, 40.0]), 50.0, 0.3, 64),
                 (np.array([10.0, 5.0]), 20.0, 0.0, 32)):
        np.testing.assert_array_equal(timg.get_transform(*args),
                                      jimg.get_transform(*args))
        np.testing.assert_array_equal(
            timg.transform_point([3, 4], *args, invert=True),
            jimg.transform_point([3, 4], *args, invert=True))
        im = np.random.RandomState(0).rand(80, 90, 3).astype(np.float32)
        np.testing.assert_array_equal(timg.crop(im, *args),
                                      jimg.crop(im, *args))
    for c in ((5, 5), (0, 30), (60, 2)):
        np.testing.assert_array_equal(
            timg.draw_gaussian(np.zeros((40, 50), np.float32), c, 2.0),
            jimg.draw_gaussian(np.zeros((40, 50), np.float32), c, 2.0))


def test_visualization_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    a = (rng.rand(40, 60, 3) * 255).astype(np.uint8)
    b = (rng.rand(40, 60, 3) * 255).astype(np.uint8)
    src, tgt = rng.rand(7, 2) * 40, rng.rand(7, 2) * 40
    np.testing.assert_array_equal(tvis.draw_match(a, b, src, tgt),
                                  jvis.draw_match(a, b, src, tgt))
    np.testing.assert_array_equal(tvis.draw_keypoints((40, 60), src),
                                  jvis.draw_keypoints((40, 60), src))
    lab = rng.randint(0, 25, (12, 16))
    for ds in ("suncg", "matterport", "scannet"):
        np.testing.assert_array_equal(tvis.colorize_semantics(lab, ds),
                                      jvis.colorize_semantics(lab, ds))
    for x, y in zip(tvis.vis_norm([a, b]), jvis.vis_norm([a, b])):
        np.testing.assert_array_equal(x, y)
    pc = rng.rand(3, 5)
    tvis.pc2obj(str(tmp_path / "t.obj"), pc)
    jvis.pc2obj(str(tmp_path / "j.obj"), pc)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()


@pytest.mark.parametrize("name, args, kwargs", [
    ("plot_series", ([[1, 3, 2], [2, 2, 1]],), dict(labels=["a", "b"])),
    ("plot_histogram", (np.arange(50) % 7,), {}),
    ("plot_cumulative", ([np.arange(9), np.arange(4)],), dict(x_max=8)),
    ("plot_keypoints_3d", (np.arange(30).reshape(10, 3),), {}),
    ("plot_voxels", (np.eye(4)[:, :, None] * np.ones(4),), {}),
    ("plot_keypoint_sets", (np.arange(36.0).reshape(2, 3, 6) ** 0.5,),
     dict(edges=[(0, 1), (2, 3)])),
    ("plot_contour", (np.outer(np.arange(8), np.arange(9)),), {}),
])
def test_plot_matches_jax(name, args, kwargs):
    np.testing.assert_array_equal(getattr(tplot, name)(*args, **kwargs),
                                  getattr(jplot, name)(*args, **kwargs))


def test_keypoint_sets_align_with_the_ports_horn():
    """align=True aligns through each package's Horn solver (f32 in both;
    a pixel may land elsewhere where the rotations round apart)."""
    rng = np.random.RandomState(2)
    kp = rng.rand(3, 3, 8)
    a = tplot.plot_keypoint_sets(kp, align=True)
    b = jplot.plot_keypoint_sets(kp, align=True)
    assert a.shape == b.shape
    assert np.mean(np.any(a != b, axis=-1)) < 0.01


def test_drawing_modules_import_without_cv2_or_matplotlib():
    """The card's machine has neither: importing the modules must not
    need them."""
    code = ("import sys\n"
            "sys.modules['cv2'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            "from relativepose_tpu_torch.utils import img, plot, "
            "visualization, profiling\n"
            "print(img.get_transform([1, 2], 3.0, 0.0, 8).shape)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def _rotation(name):
    import jax.numpy as jnp

    from relativepose_tpu.core import rotation as jrot
    from relativepose_tpu_torch.core import rotation as trot
    angles = np.random.default_rng(0).uniform(-4, 4, (3, 5)).astype(
        np.float32)
    for a in (angles, np.float32(0.25)):
        want = np.asarray(getattr(jrot, name)(jnp.asarray(a)))
        got = getattr(trot, name)(torch.as_tensor(a)).numpy()
        assert got.shape == want.shape == np.shape(a) + (3, 3)
        # cos and sin of f32 angles: the libraries' results differ by 1 ulp
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _meter(monkeypatch):
    import time

    from relativepose_tpu.utils import log as jlog
    from relativepose_tpu_torch.utils import log as tlog
    clock = iter([100.0, 102.0, 104.0, 104.0] * 2)
    monkeypatch.setattr(time, "time", lambda: next(clock))
    states = []
    for mod in (jlog, tlog):
        m = mod.FrequencyAverageMeter()
        m.update(3)
        m.update(1)
        m.update(0)   # no time passed since the last call but one
        states.append(vars(m))
    assert states[0] == states[1] == {"start": 100.0, "count": 4,
                                      "rate": 1.0}


def _logs(name, capsys):
    from relativepose_tpu.utils import log as jlog
    from relativepose_tpu_torch.utils import log as tlog
    outs = []
    for mod in (jlog, tlog):
        if name == "error_log":
            with pytest.raises(RuntimeError, match="^disk full$"):
                mod.error_log("disk full")
        else:
            mod.warning_log("disk full")
        outs.append(capsys.readouterr().err)
    assert outs[0] == outs[1] and "disk full" in outs[1]


def _scheduled(capsys):
    from relativepose_tpu.utils import callbacks as jcb
    from relativepose_tpu_torch.utils import callbacks as tcb
    runs = []
    for mod in (jcb, tcb):
        seen = []

        def save(context, tag):
            seen.append((context["epoch"], tag))
            return context["epoch"] * 10

        cb = mod.ScheduledCallback(mod.CallbackLoc.epoch_end, [1, 3], save,
                                   args=("x",))
        rets = [cb.run({"epoch": e}) for e in range(5)] + [cb.run({})]
        mod.run_callbacks([cb], mod.CallbackLoc.epoch_end, {"epoch": 3})
        mod.run_callbacks([cb], mod.CallbackLoc.epoch_start, {"epoch": 1})
        runs.append((seen, rets, capsys.readouterr().err))
    assert runs[0] == runs[1]
    assert runs[1][0] == [(1, "x"), (3, "x"), (3, "x")]


@pytest.mark.parametrize("name", ["rx", "ry", "rz", "FrequencyAverageMeter",
                                  "warning_log", "error_log",
                                  "ScheduledCallback"])
def test_public_names_match_jax(name, monkeypatch, capsys):
    """The JAX package's public names in core/rotation.py, utils/log.py
    and utils/callbacks.py that the port lacked: the same values, state,
    messages and calls on the same inputs."""
    if name in ("rx", "ry", "rz"):
        _rotation(name)
    elif name == "FrequencyAverageMeter":
        _meter(monkeypatch)
    elif name == "ScheduledCallback":
        _scheduled(capsys)
    else:
        _logs(name, capsys)
