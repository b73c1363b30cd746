"""The port's orbax reader and writer (`utils/ocdbt.py`,
`utils/orbax_read.py`, `utils/orbax_write.py`, `utils/checkpoint.py`)
against orbax and tensorstore, on the CPU.

Reading: checkpoints written by the JAX package's
`relativepose_tpu.utils.checkpoint.CheckpointManager` (orbax 0.11: OCDBT,
zarr v2, zstd); the port's read must equal the JAX package's
`restore_params` leaf for leaf: the same tree, dtypes and shapes, and
values equal bit for bit (`np.array_equal`; bfloat16 leaves, a torch
tensor on the port's side, by their bits).  The OCDBT store alone is held
to tensorstore's own `kv.list()` / `kv.read()`.

Writing: the port writes the same trees; the JAX package's
`restore_params` and orbax's own restore must give back what they give
for the JAX manager's save of the tree, bit for bit; the `_METADATA` must
parse to the JAX manager's, each `.zarray` must be orbax's byte for byte,
and tensorstore's OCDBT kvstore must list and read what the port's reader
does.  Manager directories that hold only the port's earlier npz pairs,
or both formats, are read by their newest step.  Resuming a training
state across the packages: `tests/test_torch_orbax_resume.py`.
"""

import json
import os
import subprocess
import sys
import time

import jax
import ml_dtypes
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.utils.checkpoint import CheckpointManager as JaxManager
from relativepose_tpu.utils.checkpoint import load_params_npz as jload
from relativepose_tpu.utils.checkpoint import restore_params as jrestore
from relativepose_tpu.utils.checkpoint import save_params_npz
from relativepose_tpu_torch.cli import evaluate as tcli
from relativepose_tpu_torch.native import zstd
from relativepose_tpu_torch.utils import checkpoint as tckpt
from relativepose_tpu_torch.utils import orbax_read, orbax_write
from relativepose_tpu_torch.utils.ocdbt import OcdbtReader
from orbax_fixture import FIXTURE, MANIFEST, leaf_digests
from test_torch_cli import cli_args
from torch_parity import flax_scnet_params
from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(REPO, "relativepose_tpu", "data", "pretrained",
                          "suncg.comp_ft.npz")


def assert_same_tree(got, want, path="tree"):
    """The port's restore (`got`) equals orbax's (`want`) leaf for leaf."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    elif isinstance(got, torch.Tensor):
        assert want.dtype == ml_dtypes.bfloat16, path
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              want.view(np.uint16)), path
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        want, got = np.asarray(want), np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), \
            path


def save_jax(directory, state, step=1, keep=3):
    JaxManager(str(directory), keep=keep).save(step, state)
    return str(directory)


# ------------------------------------------------------------------ OCDBT


def write_ocdbt(path, config, rng):
    """Many keys, values on both sides of the inline limit, several
    commits and a deletion; returns the tensorstore store."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config}).result()
    with ts.Transaction() as txn:
        for i in range(400):
            kv.with_transaction(txn)[f"k{i:05d}/" + "x" * (i % 7)] = \
                rng.bytes(int(rng.integers(0, 300)))
    for i in range(20):
        kv[f"later{i:02d}"] = bytes([i]) * (40 * i)
    del kv["k00007/"]
    return kv


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 1024, "max_inline_value_bytes": 100},
    {"compression": {"id": "zstd", "level": 5},
     "max_decoded_node_bytes": 4096},
    {"compression": None},
], ids=["small_nodes", "zstd5", "uncompressed"])
def test_ocdbt_matches_tensorstore(tmp_path, config):
    kv = write_ocdbt(tmp_path / "db", config, np.random.default_rng(0))
    want = sorted(k.decode() for k in kv.list().result())
    reader = OcdbtReader(str(tmp_path / "db"))
    assert reader.keys() == want
    for k in want:
        assert reader.read(k) == kv.read(k).result().value, k
    if "max_decoded_node_bytes" in config:
        assert reader.height >= 1      # interior nodes
    with pytest.raises(KeyError):
        reader.read("k00007/")


def test_ocdbt_checks_crc(tmp_path):
    kv = write_ocdbt(tmp_path / "db", {}, np.random.default_rng(1))
    del kv
    path = tmp_path / "db" / "manifest.ocdbt"
    blob = bytearray(path.read_bytes())
    blob[20] ^= 0x10
    path.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtReader(str(tmp_path / "db"))


@pytest.mark.parametrize("shape, chunks, order, dtype, fill, written", [
    ((7, 5), (3, 2), "C", "<f4", 1.5, (slice(0, 7), slice(0, 5))),
    ((7, 5), (3, 2), "F", "<i4", -3, (slice(1, 4), slice(0, 2))),
    ((10,), (4,), "C", "bfloat16", 0.25, (slice(2, 5),)),
    ((4, 3, 2), (4, 3, 2), "F", "<f8", None, (slice(0, 4),)),
    ((), (), "C", "<u4", 7, ()),
], ids=["grid", "grid_F_missing", "bf16_missing", "F_one_chunk", "0d"])
def test_zarr_chunk_grids(tmp_path, shape, chunks, order, dtype, fill,
                          written):
    """zarr v2 arrays that tensorstore writes into an OCDBT store: any
    chunk grid, edge chunks cut to the shape, chunks never written read
    as the fill value, C or F order; compared with tensorstore's read."""
    rng = np.random.default_rng(0)
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                          "base": f"file://{tmp_path}/db/"},
            "path": "x", "metadata": {
                "shape": list(shape), "chunks": list(chunks), "order": order,
                "dtype": dtype, "fill_value": fill,
                "compressor": {"id": "zstd", "level": 3}}}
    arr = ts.open(spec, create=True).result()
    data = rng.standard_normal(shape) * 100
    arr[written] = data[written].astype(arr.dtype.numpy_dtype)
    want = np.asarray(arr.read().result())
    got = orbax_read.read_array(OcdbtReader(str(tmp_path / "db")), "x")
    if dtype == "bfloat16":
        got = got.view(torch.int16).numpy().view(np.uint16)
        want = want.view(np.uint16)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ trees


def dtype_tree(rng):
    tree = {dt: rng.standard_normal((3, 5)).astype(dt) for dt in
            ("float32", "float16", "float64", "int32", "int64", "uint32",
             "uint8")}
    tree["bool"] = rng.standard_normal((4, 1, 2)) > 0
    return {
        "params": tree,
        "bf16": np.asarray(rng.standard_normal((2, 7)), ml_dtypes.bfloat16),
        "scalar_f32": np.float32(2.5), "scalar_i64": np.asarray(7),
        "none": None, "empty": {},
        "seq": [np.zeros(2), None, {"q": np.ones(1, np.float32)}],
        "step": np.asarray(3),
    }


def adam_tree(rng):
    params = {"dense": {"kernel": rng.standard_normal((6, 4)).astype(
        np.float32), "bias": np.zeros(4, np.float32)},
        "bn": {"scale": np.zeros(4, np.float32)}}
    tx = optax.adam(2e-4, b1=0.5, b2=0.999)
    opt = tx.init(params)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params)
    updates, opt = tx.update(grads, opt, params)
    return {"params": optax.apply_updates(params, updates),
            "opt_state": opt, "step": np.asarray(1)}


def many_keys_tree(rng):
    return {"params": {f"layer_{i:03d}": {
        "w": rng.standard_normal((4, int(rng.integers(1, 600)))).astype(
            np.float32),
        "b": np.arange(3, dtype=np.int32) + i} for i in range(150)}}


@pytest.fixture
def small_ocdbt_nodes(monkeypatch):
    """orbax with 4 kB OCDBT nodes (it asks for 100 MB, one root node), so
    that a tree of a few hundred keys gets interior nodes."""
    from orbax.checkpoint._src.serialization import tensorstore_utils as tsu
    orig = tsu.add_ocdbt_write_options

    def small(spec, *a, **kw):
        orig(spec, *a, **kw)
        spec["config"]["max_decoded_node_bytes"] = 4096
    monkeypatch.setattr(tsu, "add_ocdbt_write_options", small)


@pytest.mark.parametrize("make", [dtype_tree, adam_tree, many_keys_tree],
                         ids=["dtypes", "adam", "many_keys"])
def test_restore_params_matches_orbax(tmp_path, request, make):
    if make is many_keys_tree:
        request.getfixturevalue("small_ocdbt_nodes")
    d = save_jax(tmp_path / "params", make(np.random.default_rng(0)), 3)
    want = jrestore(d)
    got = tckpt.restore_params(d)
    assert_same_tree(got, want)
    if make is adam_tree:
        assert isinstance(got["opt_state"], list) and \
            got["opt_state"][1] is None
        assert set(got["opt_state"][0]) == {"count", "mu", "nu"}
    if make is many_keys_tree:
        assert OcdbtReader(os.path.join(d, "checkpoint_0003")).height >= 1


@pytest.mark.parametrize("make", [dtype_tree, adam_tree, many_keys_tree],
                         ids=["dtypes", "adam", "many_keys"])
def test_port_writes_what_orbax_restores(tmp_path, make):
    """The port's save of a tree against the JAX manager's save of it:
    the same restores, metadata and arrays (many_keys with 4 kB nodes, so
    that the port writes interior nodes)."""
    tree = make(np.random.default_rng(0))
    nodes = 4096 if make is many_keys_tree else None
    port = orbax_write.save(str(tmp_path / "port" / "checkpoint_0003"),
                            tree, max_decoded_node_bytes=nodes)
    ref = os.path.join(save_jax(tmp_path / "jax", tree, 3), "checkpoint_0003")
    want = jrestore(str(tmp_path / "jax"))
    assert_same_tree(jrestore(str(tmp_path / "port")), want)
    assert_same_tree(ocp.PyTreeCheckpointer().restore(port), want)
    assert_same_tree(tckpt.restore_params(str(tmp_path / "port")), want)
    for name in ("_METADATA", "_CHECKPOINT_METADATA"):
        with open(os.path.join(port, name)) as f:
            got = json.load(f)
        with open(os.path.join(ref, name)) as f:
            expect = json.load(f)
        if name == "_CHECKPOINT_METADATA":   # but the timestamps
            for k in ("init_timestamp_nsecs", "commit_timestamp_nsecs"):
                assert 0 < got.pop(k) and expect.pop(k)
        assert got == expect, name
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{port}/"}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    reader, orbax_kv = OcdbtReader(port), OcdbtReader(ref)
    assert reader.keys() == keys == orbax_kv.keys()
    for k in keys:
        value = reader.read(k)
        assert kv.read(k).result().value == value, k
        if k.endswith("/.zarray"):
            assert value == orbax_kv.read(k), k
        else:
            assert zstd.decompress(value).tobytes() == \
                zstd.decompress(orbax_kv.read(k)).tobytes(), k
    assert reader.height >= (1 if nodes else 0)
    assert os.listdir(tmp_path / "port") == ["checkpoint_0003"]


def test_writer_refuses_what_orbax_refuses(tmp_path):
    """Leaves the reader cannot read back raise, and no checkpoint
    directory is left behind."""
    d = str(tmp_path / "checkpoint_0001")
    for tree, error in (({"s": np.asarray(["a", "b"])}, NotImplementedError),
                        ({"c": np.ones(2, np.complex64)},
                         NotImplementedError),
                        ({"z": np.zeros((0, 3), np.float32)}, ValueError),
                        ({}, ValueError)):
        with pytest.raises(error):
            orbax_write.save(d, tree)
    assert os.listdir(tmp_path) == []


def write_npz_step(directory, step, params, resume):
    """The npz pair that the port's manager wrote before it wrote orbax:
    the parameter tree (f16) and the resume arrays (f32)."""
    path = os.path.join(str(directory), f"checkpoint_{step:04d}.npz")
    tckpt.save_params_npz(path, params)
    np.savez(path.replace(".npz", ".resume.npz"), **resume)
    return path


def test_npz_only_directory_is_read(tmp_path):
    """A manager directory that holds only the port's npz pair: read by
    `restore_params` and accepted by `require_checkpoint`; with orbax
    steps beside it, the newest step of either format is read, and the
    npz wins a tie."""
    d = str(tmp_path / "params")
    rng = np.random.default_rng(0)
    trees = [{"w": rng.standard_normal(5).astype(np.float32)}
             for _ in range(4)]
    npz = write_npz_step(d, 1, trees[0], {"step": np.asarray(1, np.int64)})
    tckpt.require_checkpoint(d)
    assert_same_tree(tckpt.restore_params(d),
                     {"params": tckpt.load_params_npz(npz)})
    save_jax(d, {"params": trees[1]}, 2)
    assert_same_tree(tckpt.restore_params(d), {"params": trees[1]})
    npz = write_npz_step(d, 3, trees[2], {"step": np.asarray(3, np.int64)})
    assert_same_tree(tckpt.restore_params(d),
                     {"params": tckpt.load_params_npz(npz)})
    save_jax(d, {"params": trees[3]}, 3)              # the tie: npz wins
    assert_same_tree(tckpt.restore_params(d),
                     {"params": tckpt.load_params_npz(npz)})
    assert tckpt.CheckpointManager(d).all_steps() == [1, 2, 3]


def test_manager_steps_keep_n_and_ties(tmp_path):
    """The JAX manager's keep-N leaves steps 3 and 4; the port sees them
    and restores the newest, prefers an npz pair on a tie, and its own
    saves (orbax, which the JAX manager restores) replace a step of either
    format and keep the newest steps of either format."""
    d = tmp_path / "params"
    rng = np.random.default_rng(0)
    trees = {s: {"params": {"w": rng.standard_normal(5).astype(np.float32)},
                 "step": np.asarray(s)} for s in range(1, 7)}
    for s in range(1, 5):
        save_jax(d, trees[s], s, keep=2)
    m = tckpt.CheckpointManager(str(d), keep=2)
    assert m.all_steps() == JaxManager(str(d)).all_steps() == [3, 4]
    assert_same_tree(m.restore(), trees[4])
    assert_same_tree(m.restore(3), trees[3])
    assert_same_tree(tckpt.restore_params(str(d)), jrestore(str(d)))

    write_npz_step(d, 4, trees[4]["params"],
                   {"step": np.asarray(4, np.int64)})
    assert set(m.restore()) == {"step"}          # the tie: npz wins
    assert m.save(5, trees[5]) == m.path(5)
    assert m.all_steps() == JaxManager(str(d)).all_steps() == [4, 5]
    assert sorted(os.listdir(d)) == [
        "checkpoint_0004", "checkpoint_0004.npz",
        "checkpoint_0004.resume.npz", "checkpoint_0005"]
    assert_same_tree(JaxManager(str(d)).restore(), trees[5])
    m.save(4, trees[6])                     # replaces both formats of 4
    assert sorted(os.listdir(d)) == ["checkpoint_0004", "checkpoint_0005"]
    assert_same_tree(JaxManager(str(d)).restore(4), trees[6])
    assert_same_tree(m.restore(4), trees[6])


def test_empty_directory_raises(tmp_path):
    d = str(tmp_path / "empty")
    os.makedirs(d)
    with pytest.raises(FileNotFoundError):
        jrestore(d)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_params(d)
    with pytest.raises(FileNotFoundError):
        tckpt.require_checkpoint(d)
    assert tckpt.CheckpointManager(d).restore() is None


@pytest.mark.parametrize("layout", ["zarr3", "zlib"])
def test_unsupported_layouts_raise(tmp_path, layout):
    """A zarr3 checkpoint or a compressor other than zstd raises
    NotImplementedError with its name."""
    if layout == "zlib":
        ts.open({"driver": "zarr", "path": "x",
                 "kvstore": {"driver": "ocdbt",
                             "base": f"file://{tmp_path}/db/"},
                 "metadata": {"shape": [4], "chunks": [4], "dtype": "<f4",
                              "compressor": {"id": "zlib"}}},
                create=True).result().write(np.ones(4, np.float32)).result()
        with pytest.raises(NotImplementedError, match="zlib"):
            orbax_read.read_array(OcdbtReader(str(tmp_path / "db")), "x")
        return
    d = save_jax(tmp_path / "params", {"params": {"w": np.ones(3)}})
    meta_path = os.path.join(d, "checkpoint_0001", "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["use_zarr3"] = True
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotImplementedError, match="zarr3"):
        tckpt.restore_params(d)


def test_full_width_scnet(tmp_path, capsys):
    """The shipped SCNet (suncg.comp_ft.npz, 48.5 M values) cast to f32:
    the port's read of the JAX manager's save equals load_params_npz of
    the npz bit for bit; both read times are printed."""
    tree = jload(PRETRAINED)
    d = save_jax(tmp_path / "params", {"params": tree})
    t0 = time.perf_counter()
    ref = jrestore(d)
    t1 = time.perf_counter()
    got = tckpt.restore_params(d)
    t2 = time.perf_counter()
    assert_same_tree(got, {"params": tree})
    assert_same_tree(got, ref)
    n = sum(a.nbytes for a in jax.tree.leaves(tree))
    with capsys.disabled():
        print(f"\nfull-width SCNet, {n / 1e6:.1f} MB f32, on the host CPU "
              f"running the tests: orbax restore {t1 - t0:.3f} s, the "
              f"port's read {t2 - t1:.3f} s")


def test_full_width_scnet_written_by_port(tmp_path, capsys):
    """The shipped SCNet cast to f32, saved by the port's manager: the JAX
    package's restore_params and the port's read give it back bit for
    bit; the write time is printed."""
    tree = {"params": jload(PRETRAINED), "step": np.asarray(1, np.int32)}
    d = str(tmp_path / "params")
    t0 = time.perf_counter()
    tckpt.CheckpointManager(d).save(1, tree)
    secs = time.perf_counter() - t0
    assert_same_tree(jrestore(d), tree)
    assert_same_tree(tckpt.restore_params(d), tree)
    n = sum(a.nbytes for a in jax.tree.leaves(tree))
    with capsys.disabled():
        print(f"\nfull-width SCNet, {n / 1e6:.1f} MB f32, on the host CPU "
              f"running the tests: the port's write {secs:.3f} s")


# ------------------------------------------------------------------ fixture


def test_fixture_matches_manifest():
    with open(MANIFEST) as f:
        want = json.load(f)["leaves"]
    assert leaf_digests(jrestore(FIXTURE)) == want
    assert leaf_digests(tckpt.restore_params(FIXTURE)) == want


BLOCK = r"""
import json, sys
BLOCKED = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "numcodecs",
           "ml_dtypes", "relativepose_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
sys.path.insert(0, "tests")
"""
BLOCKER = BLOCK + r"""
from relativepose_tpu_torch.utils.checkpoint import restore_params
from orbax_fixture import FIXTURE, MANIFEST, leaf_digests
got = leaf_digests(restore_params(FIXTURE))
assert got == json.load(open(MANIFEST))["leaves"]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"leaves": len(got), "loaded": loaded}))
"""


WRITER = BLOCK + r"""
import hashlib
import numpy as np
from relativepose_tpu_torch.train import completion
from relativepose_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                     restore_params)
from relativepose_tpu_torch.utils.orbax_write import flatten
from orbax_fixture import FIXTURE, MANIFEST, leaf_digests

def digests(tree):   # any tree: each leaf's key path, dtype and sha256
    return {str([k for k, _ in keys]): leaf if isinstance(leaf, str) else (
        np.asarray(leaf).dtype.str, hashlib.sha256(np.ascontiguousarray(
            leaf).tobytes()).hexdigest()) for keys, leaf in flatten(tree)}

manager = CheckpointManager(sys.argv[1])
manager.save(1, restore_params(FIXTURE))
got = leaf_digests(restore_params(sys.argv[1]))
assert got == json.load(open(MANIFEST))["leaves"]
state = completion.init_state(completion.CompletionTrainConfig(
    ngf=2, base_width=2), "cpu")
manager.save(2, state)
assert digests(restore_params(sys.argv[1])) == digests(state.flax_state())
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(json.dumps({"leaves": len(got), "loaded": loaded}))
"""


def run_blocked(script, *args):
    proc = subprocess.run([sys.executable, "-c", script, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_reads_without_jax():
    assert run_blocked(BLOCKER) == {"leaves": 104, "loaded": []}


def test_writes_without_jax(tmp_path):
    """The write path with JAX, orbax, tensorstore and ml_dtypes blocked:
    the fixture's tree and a completion trainer's state saved by the
    port's manager and read back with every leaf's sha256."""
    assert run_blocked(WRITER, str(tmp_path / "params")) == \
        {"leaves": 104, "loaded": []}


# ------------------------------------------------------------------ CLI


TIMING = ("sec_per_pair",)   # host seconds: differ between any two runs


def test_evaluate_cli_orbax_matches_npz(tmp_path, monkeypatch):
    """`cli.evaluate --comp_ckpt <orbax manager dir>` gives the rows of
    the npz route on the same parameters (the npz's f16 values, as f32 in
    the orbax checkpoint): every column but the timing, bit for bit."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RPTPU_SYNTH_CACHE", str(tmp_path / "pairs"))
    npz = save_params_npz(str(tmp_path / "comp.npz"), flax_scnet_params(
        FlaxSCNet(ngf=8, internal_size=(64, 128))))
    d = save_jax(tmp_path / "exp_comp" / "params",
                 {"params": jload(npz), "step": np.asarray(2)}, 2)
    rows = []
    for name, ckpt in (("npz", npz), ("orbax", d)):
        rows.append(tcli.main(cli_args(
            "suncg", name, "--device", "cpu", "--method", "ours_nr",
            "--comp_ckpt", ckpt, "--ngf", "8", "--internal_size", "64x128",
            "--bf16", "0", "--maxIter", "1", "--batch_pairs", "1")
        ).error_stats)
    assert len(rows[0]) == len(rows[1]) == 1
    for a, b in zip(*rows):
        assert set(a) == set(b)
        for k in set(a) - set(TIMING):
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)
