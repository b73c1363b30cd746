"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here carries the `gpu` marker and skips without a CUDA card.
The file imports no JAX, so that it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: W within 5e-5 with counts within 2 (the bound the JAX package
holds its Pallas kernel to: the kernel's arccos and sum order differ from
the plain version's); eigenvectors to a cosine of 1 - 1e-4; pipeline poses
to 1e-3, the W difference carried through the solve; ICP poses to 1e-4
and overlap statistics to 1e-5 (plain torch on both devices, sums in
another order).  The training data path bit for bit: the decoded batch
and the dense correspondences (products with f32 constants, matmuls over
3 coordinates and the fused multiply-add chains of
`data/pipeline.py` round alike on both devices).  One f32 training step
of each trainer: its metrics to 1e-4 relative (cuDNN and the CPU sum
convolutions in another order), and the parameters after it within 1e-6
for 99.9% of them and within 2 lr = 4e-4 for all (Adam's first step
moves a parameter by lr * sign(gradient), which flips where a gradient
is near 0).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from relativepose_tpu_torch.core import overlap
from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.data import device_store as dstore
from relativepose_tpu_torch.data import pipeline as dpipe
from relativepose_tpu_torch.data import synthetic
from relativepose_tpu_torch.eval.harness import parse_eval_data
from relativepose_tpu_torch.match.keypoints import (
    KeypointConfig,
    KeypointDraws,
    detect_observed,
    rgb_to_gray,
)
from relativepose_tpu_torch.match.solver import (
    SolverHyperParams,
    SolverStaticConfig,
)
from relativepose_tpu_torch.ops import icp, kernels
from relativepose_tpu_torch.pipeline import recurrent
from relativepose_tpu_torch.pipeline.oracle import make_oracle_completion_fn
from relativepose_tpu_torch.train import completion, feature

pytestmark = pytest.mark.gpu
SMALL = dict(n_detect=32, n_match=16, n_random=8)
STEPS = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    recurrent.set_numerics()
    return torch.device("cuda")


def components(seed, b, c, device):
    """[B, C] correspondence components from a numpy seed."""
    rng = np.random.RandomState(seed)
    ps = rng.randn(b, c, 3)
    pt = ps + 0.03 * rng.randn(b, c, 3)
    ns = rng.randn(b, c, 3)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    nt = rng.randn(b, c, 3)
    f = rng.rand(b, c)
    obs = np.where(rng.rand(b, c) > 0.3, 1.0, 0.99)
    cvalid = rng.rand(b, c) > 0.1
    out = [torch.as_tensor(a, dtype=torch.float32, device=device)
           for a in (ps, pt, ns, nt, f, obs * obs)]
    return out + [torch.as_tensor(cvalid, device=device)]


@pytest.mark.parametrize("b", [1, 3, 4])
@pytest.mark.parametrize("c", [1, 63, 64, 65, 300, 1720])  # tile edges
def test_pair_weight_kernel(cuda, b, c):
    args = components(0, b, c, cuda)
    hp = SolverHyperParams()
    n0 = kernels.PAIR_WEIGHT.launches
    W, counts = kernels.pair_weight_matrix(*args, hp)
    W0, counts0 = kernels.pair_weight_matrix_plain(*args, hp)
    assert kernels.PAIR_WEIGHT.launches == n0 + 1
    torch.testing.assert_close(W, W0, rtol=0, atol=5e-5)
    assert torch.equal(W, W.transpose(-1, -2))
    assert not torch.diagonal(W, dim1=-2, dim2=-1).any()
    for k in counts:
        assert int((counts[k] - counts0[k]).abs().max()) <= 2, k
    W2, counts2 = kernels.pair_weight_matrix(*args, hp)  # deterministic
    assert torch.equal(W, W2)
    for k in counts:
        assert torch.equal(counts[k], counts2[k]), k


def test_power_iteration_checks_its_inputs(cuda):
    W = torch.rand(2, 64, 64, device=cuda)
    h = torch.rand(2, 64, device=cuda)
    with pytest.raises(TypeError):
        kernels.power_iteration(W, h.double(), 3)
    with pytest.raises(ValueError):
        kernels.power_iteration(W.transpose(1, 2), h, 3)
    with pytest.raises(ValueError):
        kernels.power_iteration(W, h[:, :32].contiguous(), 3)


@pytest.mark.parametrize("h_kind", ["random", "zero"])
@pytest.mark.parametrize("b", [1, 4, 17])  # 17: one pair past the path's 16
@pytest.mark.parametrize("c", [5, 1000, 1722])  # C < cluster, C % 4 == 0, != 0
def test_power_iteration_kernel(cuda, c, b, h_kind):
    """With h = 0 every step has norm 0, so v is kept: all ones."""
    args = components(1, b, c, cuda)
    W, _ = kernels.pair_weight_matrix_plain(*args, SolverHyperParams())
    h = torch.as_tensor(50 * np.random.RandomState(9).rand(b, c),
                        dtype=torch.float32, device=cuda)
    if h_kind == "zero":
        h = torch.zeros_like(h)
    n0 = kernels.POWER_ITER.launches
    u = kernels.power_iteration(W, h, 30)
    u0 = kernels.power_iteration_plain(W, h, 30)
    assert kernels.POWER_ITER.launches == n0 + 1
    cos = torch.nn.functional.cosine_similarity(u, u0, dim=-1)
    assert bool((cos >= 1 - 1e-4).all()), cos
    assert torch.equal(u, kernels.power_iteration(W, h, 30))  # deterministic
    if h_kind == "zero":
        assert torch.equal(u, torch.ones_like(u))


@pytest.mark.parametrize("b, c", [(0, 64), (2, 0)])
def test_empty_inputs_launch_nothing(cuda, b, c):
    """An empty batch or no correspondences: empty outputs, zero counts,
    and no launch counted."""
    args = components(0, b, c, cuda)
    n0 = (kernels.PAIR_WEIGHT.launches, kernels.POWER_ITER.launches)
    W, counts = kernels.pair_weight_matrix(*args, SolverHyperParams())
    u = kernels.power_iteration(W, torch.ones(b, c, device=cuda), 30)
    assert W.shape == (b, c, c) and u.shape == (b, c)
    for k in counts:
        assert counts[k].shape == (b,) and not counts[k].any(), k
    assert (kernels.PAIR_WEIGHT.launches, kernels.POWER_ITER.launches) == n0


def numpy_draws(seed, b, cfg, device):
    """Keypoint draws for every step from a numpy seed."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        d = dict(sel_t1=rng.randint(0, cfg.n_detect, (b, cfg.n_match)),
                 sel_s=rng.randint(0, cfg.n_detect, (b, cfg.n_match)),
                 rnd_u=rng.rand(b, 2, cfg.n_random).astype(np.float32),
                 sel_t2=rng.randint(0, cfg.n_random, (b, cfg.n_random)))
        out.append(KeypointDraws(**{k: torch.as_tensor(v, device=device)
                                    for k, v in d.items()}))
    return out


def stacked_pairs(seeds, dataset):
    pairs = [synthetic.make_pair(s, dataset, max_baseline=0.5)
             for s in seeds]
    ds, dt = ({k: np.stack([p[v][k] for p in pairs]) for k in pairs[0][v]
               if k != "pose"} for v in (0, 1))
    return ds, dt, np.stack([p[2] for p in pairs]).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pipeline_on_card_matches_cpu(cuda, use_pallas):
    """The kernels' path on the card against the plain path on the CPU,
    with the same draws and oracle completion."""
    ds, dt, _ = stacked_pairs((25, 26), "suncg")
    cfg = recurrent.PipelineConfig(
        alter_steps=STEPS, keypoints=KeypointConfig(**SMALL),
        solver=SolverStaticConfig(power_iters=5, use_pallas=use_pallas))
    assert_card_matches_cpu(ds, dt, cfg)


def assert_card_matches_cpu(ds, dt, cfg):
    """Every step's pose of the oracle pipeline on the card within 1e-3
    of the CPU's, on the same draws; with use_pallas both kernels ran."""
    n0 = {k: v.launches for k, v in kernels.KERNELS.items()}
    poses = {}
    for device in ("cpu", "cuda"):
        oracle = make_oracle_completion_fn(
            recurrent.as_pair_batch(ds, device),
            recurrent.as_pair_batch(dt, device), cfg.layout)
        poses[device] = recurrent.estimate_pose_via_completion(
            oracle, ds, dt, SolverHyperParams(), cfg,
            draws=numpy_draws(0, 2, cfg.keypoints, device),
            return_step_poses=True, device=device)[1].cpu()
    torch.testing.assert_close(poses["cuda"], poses["cpu"], rtol=0,
                               atol=1e-3)
    assert kernels.PAIR_WEIGHT.launches == n0["pair_weight_matrix"] + STEPS
    if cfg.solver.use_pallas:
        assert kernels.POWER_ITER.launches > n0["power_iteration"]


def test_kinect_detection_on_card_matches_cpu(cuda):
    """DoG on the 480x640 frames, remapped into the kinect window: the same
    keypoints on the card as on the CPU, bit for bit (the remap divides by
    a tensor, since CUDA multiplies by the rounded reciprocal of a Python
    divisor)."""
    ds, _, _ = stacked_pairs((15, 16), "scannet")
    out = {}
    for device in ("cpu", "cuda"):
        gray = rgb_to_gray(torch.as_tensor(ds["rgb_full"], device=device)
                           * 255.0)
        out[device] = [x.cpu() for x in detect_observed(
            None, KeypointConfig(**SMALL), gray)]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)
    assert int(out["cpu"][1].sum()) > 40


@pytest.mark.parametrize("options", [
    dict(),
    dict(icp_iters=2, solver=SolverStaticConfig(
        power_iters=5, use_pallas=True, refit_rounds=2,
        trans_refine_rounds=2))])
def test_scannet_pipeline_on_card_matches_cpu(cuda, options):
    """The ScanNet kinect path (DoG on the 480x640 frames, the kinect
    warp), and with the refit, trans-refine and ICP options, on the card
    against the CPU."""
    ds, dt, _ = stacked_pairs((15, 16), "scannet")
    options = {"solver": SolverStaticConfig(power_iters=5, use_pallas=True),
               **options}
    cfg = recurrent.PipelineConfig(
        dataset="scannet", mask_method="kinect", alter_steps=STEPS,
        keypoints=KeypointConfig(**SMALL), **options)
    assert_card_matches_cpu(ds, dt, cfg)


@pytest.mark.parametrize("dof", [6, 3])
def test_icp_polish_on_card_matches_cpu(cuda, dof):
    ds, dt, T_gt = stacked_pairs((11, 13), "suncg")
    T0 = T_gt.copy()
    T0[:, :3, 3] += np.array([0.1, -0.05, 0.08], np.float32)
    out = {}
    for device in ("cpu", "cuda"):
        args = [torch.as_tensor(a, device=device).float() for a in
                (T0, ds["depth"], ds["norm"], dt["depth"], dt["norm"])]
        obs = torch.zeros(args[1].shape, device=device)
        obs[:, :, 160:320] = 1.0
        out[device] = icp.icp_polish(*args, "suncg", iters=5, dof=dof,
                                     obs_s=obs, obs_t=obs).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-4)
    assert not torch.allclose(out["cpu"], torch.as_tensor(T0))


@pytest.mark.parametrize("dataset", ["suncg", "scannet"])
def test_overlap_on_card_matches_cpu(cuda, dataset):
    ds, dt, T_gt = stacked_pairs((3, 4), dataset)
    out = {}
    for device in ("cpu", "cuda"):
        clouds = [parse_eval_data(
            torch.as_tensor(d["depth"], device=device),
            torch.as_tensor(d["rgb"], device=device), None, dataset,
            "ours")[:2] for d in (ds, dt)]
        out[device] = overlap.point_cloud_overlap(
            *clouds[0], *clouds[1], torch.as_tensor(T_gt, device=device))
    for k in out["cpu"]:
        torch.testing.assert_close(out["cuda"][k].cpu(), out["cpu"][k],
                                   rtol=1e-5, atol=1e-5)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(to_device(v, device) for v in tree))
    return tree.to(device)


def store_batches(dataset, cuda):
    """One gather from the same resident store on the CPU and the card,
    with the CPU's draws."""
    src = dsets.SyntheticPairs(dataset, n=3, seed=11, full_frames=False)
    cpu = dstore.DeviceStore(src, device="cpu", with_full_frames=False)
    card = dstore.DeviceStore(src, device=cuda, with_full_frames=False)
    idx = torch.tensor([2, 0])
    depth = dstore.decode_batch(*(cpu.arrays[k][idx] for k in
                                  ("rgb", "norm", "depth", "segm")))[2]
    draws = dpipe.draw_pair_batch(depth, dataset,
                                  torch.Generator().manual_seed(5))
    return (dstore.gather_batch(cpu.arrays, idx, dataset, draws=draws),
            dstore.gather_batch(card.arrays, idx.to(cuda), dataset,
                                draws=to_device(draws, cuda)))


@pytest.mark.parametrize("dataset", ["suncg", "scannet"])
def test_training_batch_on_card_matches_cpu(cuda, dataset):
    cpu, card = store_batches(dataset, cuda)
    for k in ("rgb", "norm", "depth", "segm", "dataMask"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    for k in ("idx_src", "idx_tgt", "valid"):
        assert torch.equal(card["denseCorres"][k].cpu(),
                           cpu["denseCorres"][k]), k
    assert bool(cpu["denseCorres"]["valid"].all())


@pytest.mark.parametrize("trainer", ["feature", "completion"])
def test_training_step_on_card_matches_cpu(cuda, trainer):
    batch, _ = store_batches("suncg", cuda)
    gen = torch.Generator().manual_seed(6)
    if trainer == "feature":
        cfg = feature.FeatureTrainConfig(base_width=8)
        state = feature.init_state(cfg, "cpu", seed=1)
        draws = feature.draw_negatives(cfg, batch, gen)
        step = feature.train_step
    else:
        cfg = completion.CompletionTrainConfig(ngf=8, base_width=8)
        state = completion.init_state(cfg, "cpu", seed=1)
        draws = completion.draw(cfg, batch, gen)
        step = completion.train_step
    card = copy.deepcopy(state)
    for m in list(card.models.values()) + list(card.frozen.values()):
        m.to(cuda)
    card.optimizer = type(state.optimizer)(card.parameters(),
                                           **state.optimizer.defaults)
    for p in card.parameters():
        p.grad = torch.zeros_like(p)
    m_cpu = step(state, batch, draws, cfg)
    m_card = step(card, to_device(batch, cuda), to_device(draws, cuda), cfg)
    for k, v in m_cpu.items():
        np.testing.assert_allclose(float(m_card[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    d = torch.cat([(a.detach().cpu() - b.detach()).abs().ravel() for a, b in
                   zip(card.parameters(), state.parameters())])
    assert float(d.max()) <= 4e-4
    assert float((d <= 1e-6).float().mean()) >= 0.999



def test_kernels_refuse_inputs_that_require_grad(cuda):
    """The CUDA kernels have no backward: a call whose inputs (or tensor
    sigmas) require grad while grad mode is on raises, and launches
    nothing; under no_grad the same call launches."""
    args = components(0, 2, 64, cuda)
    ps = args[0].clone().requires_grad_(True)
    sig = torch.tensor(0.04, device=cuda, requires_grad=True)
    n0 = kernels.PAIR_WEIGHT.launches
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.pair_weight_matrix(ps, *args[1:], SolverHyperParams())
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.pair_weight_matrix(*args, SolverHyperParams(sigma_dist=sig))
    W, _ = kernels.pair_weight_matrix(*args, SolverHyperParams())
    h = torch.ones(2, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.power_iteration(W, h, 3)
    assert kernels.PAIR_WEIGHT.launches == n0 + 1
    with torch.no_grad():
        kernels.pair_weight_matrix(ps, *args[1:],
                                   SolverHyperParams(sigma_dist=sig))
        kernels.power_iteration(W, h, 3)
    assert kernels.PAIR_WEIGHT.launches == n0 + 2


def test_sigma_objective_with_kernel_matches_plain(cuda):
    """The sigma tuner's objective with the pair-weight kernel (the 'fd'
    path) against the plain W build, at sigma0 and a perturbed sigma, on
    primitives the oracle pipeline caches on the card: to 1e-4
    relative."""
    from relativepose_tpu_torch.tune import sigma as st
    ds, dt, T_gt = stacked_pairs((27, 28, 29), "suncg")
    cfg = recurrent.PipelineConfig(
        alter_steps=STEPS, keypoints=KeypointConfig(**SMALL),
        solver=SolverStaticConfig(power_iters=5))
    by_level, rgt = st.cache_primitives(
        lambda a, b, p: make_oracle_completion_fn(a, b, cfg.layout),
        [(ds, dt, T_gt)], SolverHyperParams(), cfg,
        generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    prims = st.stack_primitives(by_level[0], cuda)
    n0 = kernels.PAIR_WEIGHT.launches
    for sig in ([0.2615, 0.2615, 0.04, 0.01], [0.3, 0.2, 0.05, 0.02]):
        vals = [float(st.make_objective(*prims, rgt, SolverStaticConfig(
            pallas_w_build=k))(np.asarray(sig, np.float32)))
            for k in (True, False)]
        np.testing.assert_allclose(vals[0], vals[1], rtol=1e-4)
    assert kernels.PAIR_WEIGHT.launches == n0 + 2


def test_finetune_remat_on_card_matches_no_remat(cuda):
    """One fine-tuning loss and its gradients on the card (f32 SCNet), with
    and without remat, on the same draws: the loss equal, the gradients to
    a cosine of 1 - 1e-4 and norms within 1e-3 (cuDNN's backward may sum
    in another order on each run).  f32 convolutions on the card differ
    from one call to the next unless cuDNN is held to deterministic
    algorithms, enough to move a keypoint and the loss by 5 %: the
    rematerialised steps hold it themselves, and the plain run is held
    here."""
    from relativepose_tpu_torch.models.scnet import SCNet
    from relativepose_tpu_torch.train import finetune_pose as ft
    ds, dt, T_gt = stacked_pairs((30, 31), "suncg")
    torch.manual_seed(0)
    net = SCNet(ngf=8).to(cuda)
    cfg_ft = ft.PoseFinetuneConfig(ngf=8)
    out = {}
    assert not torch.backends.cudnn.deterministic
    for remat in (True, False):
        cfg = recurrent.PipelineConfig(
            alter_steps=STEPS, keypoints=KeypointConfig(**SMALL), remat=remat,
            solver=SolverStaticConfig(power_iters=5, pallas_w_build=False))
        with (contextlib.nullcontext() if remat
              else recurrent.cudnn_deterministic()):
            loss, _ = ft.loss_fn(
                net, None, recurrent.as_pair_batch(ds, cuda),
                recurrent.as_pair_batch(dt, cuda),
                torch.as_tensor(T_gt, device=cuda), cfg,
                SolverHyperParams(), cfg_ft,
                draws=numpy_draws(3, 2, cfg.keypoints, cuda))
            g = torch.autograd.grad(loss, list(net.parameters()),
                                    allow_unused=True)
        out[remat] = (float(loss), torch.cat([x.flatten() for x in g
                                              if x is not None]))
    assert out[True][0] == out[False][0]
    a, b = out[True][1], out[False][1]
    assert bool(torch.isfinite(a).all()) and float(a.norm()) > 0
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    assert cos >= 1 - 1e-4, cos
    np.testing.assert_allclose(float(a.norm()), float(b.norm()), rtol=1e-3)


def test_gather_eval_pairs_on_card_matches_cpu(cuda):
    from relativepose_tpu_torch.train import finetune_pose as ft
    src = dsets.SyntheticPairs("scannet", n=3, seed=12)
    idx = torch.tensor([2, 0])
    cpu = ft.gather_eval_pairs(dstore.DeviceStore(src, device="cpu").arrays,
                               idx)
    card = ft.gather_eval_pairs(dstore.DeviceStore(src, device=cuda).arrays,
                                idx.to(cuda))
    for a, b in zip(cpu[:2], card[:2]):
        assert set(a) == set(b) == {"rgb", "norm", "depth", "rgb_full"}
        for k in a:
            assert torch.equal(b[k].cpu(), a[k]), k
    torch.testing.assert_close(card[2].cpu(), cpu[2], rtol=0, atol=1e-6)


def test_classical_gs_with_bookkeeping_on_card_matches_cpu(
        cuda, tmp_path, monkeypatch):
    """`--method gs`: the clouds, overlap and errors in torch on the card,
    the registration in the native library; the same pairs recorded with
    the same poses as with the bookkeeping on the CPU."""
    from relativepose_tpu_torch.cli import evaluate
    runs = {}
    for dev in ("cpu", "cuda"):
        (tmp_path / dev).mkdir()
        monkeypatch.chdir(tmp_path / dev)
        runs[dev] = evaluate.main([
            "--dataList", "synthetic", "--synthetic_family", "suncg",
            "--method", "gs", "--maxIter", "4", "--rm", "--exp", "gs",
            "--device", dev]).error_stats
    assert len(runs["cuda"]) >= 2
    assert [r["pair_idx"] for r in runs["cuda"]] == \
        [r["pair_idx"] for r in runs["cpu"]]
    for a, b in zip(runs["cpu"], runs["cuda"]):
        np.testing.assert_allclose(b["T_hat"], a["T_hat"], atol=1e-4)
        for k in ("overlap", "cam_dist", "pc_dist", "pc_nn"):
            np.testing.assert_allclose(float(b[k]), float(a[k]), atol=1e-5,
                                       err_msg=k)
        for k in ("err_ad", "err_t"):
            np.testing.assert_allclose(float(b[k]), float(a[k]), atol=1e-3,
                                       err_msg=k)


def test_one_rank_nccl_step_matches_plain_step(cuda, tmp_path):
    """`train/mesh.py` on a 1-rank NCCL group (batch statistics and loss
    sums through NCCL, DDP over the group) against the step without a
    group, f32, the small dry-run step: the loss to 1e-6 relative, the
    parameters as the training steps above, and the sharded evaluation's
    poses to 1e-5."""
    from relativepose_tpu_torch.train import mesh_dryrun
    ref = mesh_dryrun.step(device="cuda")
    got = mesh_dryrun.one_rank_step(str(tmp_path), "cuda")
    assert abs(got[0]["loss"] - ref[0]["loss"]) <= 1e-6 * ref[0]["loss"]
    diff = np.concatenate([np.abs(got[1][k] - ref[1][k]).ravel()
                           for k in ref[1]])
    assert np.mean(diff <= 1e-6) >= 0.999 and diff.max() <= 2 * 2e-4
    np.testing.assert_allclose(got[2], ref[2], atol=1e-5)


def test_orbax_fixture_drives_scnet_on_card(cuda):
    """The committed orbax fixture (written by the JAX package's orbax
    manager) read on the card's host by the port's own zstd decoder and
    OCDBT reader: every leaf's sha256 as recorded; the SCNet it holds
    runs on the card with finite outputs within 1e-3 of the CPU's (f32;
    cuDNN sums its convolutions in another order)."""
    import json

    from orbax_fixture import FIXTURE, MANIFEST, leaf_digests
    from relativepose_tpu_torch.models import convert
    from relativepose_tpu_torch.models.scnet import SCNet
    from relativepose_tpu_torch.utils.checkpoint import restore_params

    with open(MANIFEST) as f:
        record = json.load(f)
    tree = restore_params(FIXTURE)
    assert leaf_digests(tree) == record["leaves"]
    net = convert.load_flax_params(SCNet(ngf=record["ngf"]), tree["params"])
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 160, 640, 16).astype(np.float32))
    with torch.no_grad():
        want = net.eval()(x)
        got = net.to(cuda)(x.to(cuda)).cpu()
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def test_orbax_checkpoint_of_a_card_step(cuda, tmp_path, monkeypatch):
    """A completion state (ngf 8) trained one step on the card, saved by
    the port's manager as an orbax checkpoint and read back: every leaf,
    its dtype and its bits as `flax_state()` gives them; the evaluation
    CLI on the card then runs from that params directory (`--comp_ckpt`)
    to finite orthonormal poses."""
    from relativepose_tpu_torch.cli import evaluate
    from relativepose_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        restore_params,
    )
    from relativepose_tpu_torch.utils.orbax_write import flatten

    _, batch = store_batches("suncg", cuda)
    cfg = completion.CompletionTrainConfig(ngf=8, base_width=8)
    state = completion.init_state(cfg, cuda, seed=1)
    completion.train_step(state, batch, completion.draw(
        cfg, batch, torch.Generator(device=cuda).manual_seed(6)), cfg)
    params = str(tmp_path / "exp_card" / "params")
    CheckpointManager(params).save(state.step, state)
    want = {str([k for k, _ in keys]): v
            for keys, v in flatten(state.flax_state())}
    got = {str([k for k, _ in keys]): v
           for keys, v in flatten(restore_params(params))}
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, str):        # an empty node
            assert got[k] == v, k
        else:
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(got["['step']"]) == 1
    monkeypatch.chdir(tmp_path)
    rows = evaluate.main([
        "--dataList", "synthetic", "--synthetic_family", "suncg",
        "--method", "ours", "--maxIter", "4", "--batch_pairs", "4",
        "--comp_ckpt", params, "--ngf", "8", "--rm", "--exp", "orbax_card",
        "--device", "cuda"]).error_stats
    assert rows
    for r in rows:
        T = np.asarray(r["T_hat"], np.float64)
        assert np.isfinite(T).all()
        R = T[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-3)
