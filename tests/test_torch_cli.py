"""The port's evaluation CLI against relativepose_tpu.cli.evaluate, on the
CPU, and the rule that the port imports no JAX.

The CLI comparison runs both drivers' `main` on the same two synthetic
pairs with oracle completion at `--n_detect 32` (the JAX driver itself,
not the harness: it compiles in seconds here).  The two runs draw
different keypoints, so only the columns that do not depend on the
draws are compared, to 1e-4: overlap, cam_dist, err_blind and err_t_id;
the summaries must have the same keys."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from relativepose_tpu.cli import evaluate as jcli
from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.utils.checkpoint import load_params_npz as jload
from relativepose_tpu.utils.checkpoint import save_params_npz
from relativepose_tpu_torch.cli import evaluate as tcli
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.utils.checkpoint import load_params_npz as tload
from torch_parity import flax_scnet_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETERMINISTIC = ("overlap", "cam_dist", "err_blind", "err_t_id")


def cli_args(family, exp, *extra):
    return ["--dataList", "synthetic", "--synthetic_family", family,
            "--method", "ours", "--n_detect", "32", "--maxIter", "2",
            "--batch_pairs", "2", "--rm", "--exp", exp, *extra]


@pytest.mark.parametrize("family", ["suncg", "scannet"])
def test_evaluate_cli_matches_jax(tmp_path, monkeypatch, family):
    monkeypatch.chdir(tmp_path)
    rj = jcli.main(cli_args(family, "jx"))
    rt = tcli.main(cli_args(family, "pt", "--device", "cpu"))
    assert len(rj.error_stats) == len(rt.error_stats) == 2
    for a, b in zip(rj.error_stats, rt.error_stats):
        for k in DETERMINISTIC:
            np.testing.assert_allclose(float(a[k]), float(b[k]), atol=1e-4,
                                       err_msg=k)
        assert set(a) == set(b)
        assert np.isfinite(b["T_hat"]).all()
    assert set(rj.summary()) == set(rt.summary())
    assert os.path.exists(tmp_path / "tmp/rpe/pt/pt.result.npy")
    assert len(np.load(tmp_path / "tmp/rpe/pt/pt.result.npy",
                       allow_pickle=True)) == 2


def test_evaluate_cli_runs_without_jax(tmp_path):
    """The acceptance command, in a fresh process: scannet, oracle
    completion, on the CPU; it prints the summary JSON and no module of
    JAX or of the JAX package is loaded."""
    code = (
        "import sys\n"
        "from relativepose_tpu_torch.cli import evaluate\n"
        "evaluate.main(sys.argv[1:])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'relativepose_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code, *cli_args("scannet", "nojax"),
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["rot_0-0.1"] is not None or \
        summary["rot_0.1-0.5"] is not None


def test_port_imports_no_jax():
    """No module of the port and nothing in chip_smoke.py imports JAX,
    Flax or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                     r"relativepose_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "relativepose_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
    # and importing the modules of the last slice loads none of them
    mods = ["native.registration", "eval.baselines", "utils.torch_import",
            "train.mesh", "train.mesh_dryrun", "utils.profiling",
            "utils.img", "utils.plot", "utils.visualization"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('relativepose_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'relativepose_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_flags_match_jax():
    """The port's driver takes the JAX driver's flags, plus --device; the
    scannet family forces the kinect mask in both."""
    for argv in ([], ["--dataList", "synthetic", "--synthetic_family",
                      "scannet", "--maskMethod", "second"]):
        a, b = vars(jcli._parse_args(argv)), vars(tcli._parse_args(argv))
        assert set(b) == set(a) | {"device"}
        assert {k: b[k] for k in a} == a
    assert b["maskMethod"] == "kinect" and b["device"] == "cuda"


@pytest.mark.parametrize("extra, match", [
    (["--comp_ckpt", "experiments/exp_comp/params"], "orbax"),
    (["--comp_ckpt", "params_dir", "--method", "ours_nr"], "tensorstore"),
    (["--comp_ckpt", "params_dir", "--method", "ours_nc"],
     "save_params_npz")])
def test_unported_options_raise(tmp_path, monkeypatch, extra, match):
    """Orbax checkpoint directories are the one input the port does not
    read; the error gives the reason and the npz route."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(cli_args("suncg", "x", "--device", "cpu", *extra))


def test_comp_ckpt_npz(tmp_path, monkeypatch):
    """An npz weight file (the JAX package's format) loads through the
    port's own load_params_npz and converter, and drives the CLI."""
    monkeypatch.chdir(tmp_path)
    fnet = FlaxSCNet(ngf=8, internal_size=(64, 128))
    path = save_params_npz(str(tmp_path / "comp.npz"),
                           flax_scnet_params(fnet))
    flat_j = convert.flatten_params(jload(path))
    flat_t = convert.flatten_params(tload(path))
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_j[k], flat_t[k])
    runner = tcli.main(cli_args(
        "suncg", "ck", "--device", "cpu", "--method", "ours_nr",
        "--comp_ckpt", path, "--ngf", "8", "--internal_size", "64x128",
        "--bf16", "0"))
    assert len(runner.error_stats) == 2
    for r in runner.error_stats:
        assert np.isfinite(float(r["err_ad"]))
        assert np.isfinite(r["T_hat"]).all()
