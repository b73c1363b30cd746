"""The port's Zstandard decoder (`native/zstd.cpp`) against real encoders.

Frames come from tensorstore's zarr driver with `"compressor": {"id":
"zstd", "level": L}` over a `file` kvstore, so each chunk file is one bare
zstd frame, the very frames that orbax checkpoints hold (streaming frames:
no content size, no checksum).  Where ctypes finds `libzstd.so`, frames
with a content checksum, with a content size, empty and concatenated ones
come from libzstd itself.  The decoder's output must equal the encoder's
input byte for byte; malformed frames must raise ValueError, in a child
process, so that a crash fails the test instead of the test run.  The
frames of raw blocks that `zstd.frame_raw` writes are read back by the
port's decoder, by tensorstore's zarr driver and by libzstd.
"""

import ctypes
import ctypes.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import tensorstore as ts

from relativepose_tpu_torch.native import zstd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("f32", "zeros", "int32", "pattern", "text")


def make_data(kind: str, size: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    n4 = -(-size // 4)
    if kind == "f32":            # random weights: Huffman-coded literals
        b = rng.standard_normal(n4).astype(np.float32).tobytes()
    elif kind == "f16f32":       # f16 weights cast to f32, as checkpoints
        b = rng.standard_normal(n4).astype(np.float16).astype(
            np.float32).tobytes()
    elif kind == "zeros":
        b = bytes(size)
    elif kind == "int32":        # low entropy: FSE sequences, short matches
        b = rng.integers(0, 20, n4).astype(np.int32).tobytes()
    elif kind == "pattern":      # one period repeated: long overlapping copies
        b = bytes(range(251)) * (size // 251 + 1)
    else:
        b = b"".join(b"line %d of a short text; " % i
                     for i in range(size // 20 + 1))
    return b[:size]


def ts_frame(tmp_path, data: bytes, level: int) -> bytes:
    """`data` as tensorstore's zarr driver compresses a chunk."""
    path = str(tmp_path / f"zarr_{level}_{len(data)}")
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "file", "path": path},
                   "metadata": {"compressor": {"id": "zstd", "level": level},
                                "dtype": "|u1", "shape": [len(data)],
                                "chunks": [len(data)]},
                   "store_data_equal_to_fill_value": True},
                  create=True, delete_existing=True).result()
    arr.write(np.frombuffer(data, np.uint8)).result()
    with open(os.path.join(path, "0"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("level", [1, 3, 9, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_decodes_tensorstore_chunks(tmp_path, kind, level):
    data = make_data(kind, 300_000)
    frame = ts_frame(tmp_path, data, level)
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    assert zstd.decompress(frame).tobytes() == data
    out = np.empty(len(data), np.uint8)
    assert zstd.decompress_into(frame, out) == len(data)
    assert out.tobytes() == data


@pytest.mark.parametrize("size, kind, level", [
    (1, "text", 3), (100, "text", 3), (4096, "int32", 3),
    (131_073, "f16f32", 3),             # two blocks
    (1 << 20, "f16f32", 9),
    (8 << 20, "f16f32", 3),             # 64 blocks, 2 MB window
    (8 << 20, "pattern", 19),           # 8 MB window
], ids=lambda v: str(v))
def test_sizes(tmp_path, size, kind, level):
    data = make_data(kind, size, seed=size)
    frame = ts_frame(tmp_path, data, level)
    out = np.empty(size, np.uint8)
    assert zstd.decompress_into(frame, out) == size
    assert out.tobytes() == data


def _libzstd():
    name = ctypes.util.find_library("zstd")
    if name is None:
        return None
    lib = ctypes.CDLL(name)
    sz, p = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_createCCtx.restype = p
    lib.ZSTD_freeCCtx.argtypes = [p]
    lib.ZSTD_CCtx_setParameter.argtypes = [p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = sz
    lib.ZSTD_compress2.argtypes = [p, p, sz, p, sz]
    lib.ZSTD_compress2.restype = sz
    lib.ZSTD_compressBound.argtypes = [sz]
    lib.ZSTD_compressBound.restype = sz
    lib.ZSTD_isError.argtypes = [sz]
    lib.ZSTD_decompress.argtypes = [p, sz, p, sz]
    lib.ZSTD_decompress.restype = sz
    lib.ZSTD_getFrameContentSize.argtypes = [p, sz]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    return lib


LEVEL, CONTENT_SIZE, CHECKSUM = 100, 200, 201   # ZSTD_cParameter values


def libzstd_frame(lib, data: bytes, level=3, checksum=False,
                  content_size=True) -> bytes:
    cctx = lib.ZSTD_createCCtx()
    try:
        for param, value in ((LEVEL, level), (CHECKSUM, int(checksum)),
                             (CONTENT_SIZE, int(content_size))):
            assert not lib.ZSTD_isError(
                lib.ZSTD_CCtx_setParameter(cctx, param, value))
        dst = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)))
        n = lib.ZSTD_compress2(cctx, dst, len(dst), data, len(data))
        assert not lib.ZSTD_isError(n)
        return dst.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def skippable(payload: bytes) -> bytes:
    return (0x184D2A53).to_bytes(4, "little") + \
        len(payload).to_bytes(4, "little") + payload


@pytest.fixture(scope="module")
def libzstd():
    lib = _libzstd()
    if lib is None:
        pytest.skip("libzstd.so not found by ctypes")
    return lib


@pytest.mark.parametrize("case", ["checksum", "content_size", "empty",
                                  "concatenated"])
def test_libzstd_frames(libzstd, case):
    a, b = make_data("int32", 200_000), make_data("text", 70_000)
    if case == "checksum":
        frame, want = libzstd_frame(libzstd, a, 19, checksum=True), a
        assert frame[4] & 4                       # the checksum flag
    elif case == "content_size":
        frame, want = libzstd_frame(libzstd, b, 9), b
        assert zstd.content_size(frame) == len(b)
    elif case == "empty":
        frame, want = libzstd_frame(libzstd, b"", 3, checksum=True), b""
        assert zstd.content_size(frame) == 0
    else:
        frame = libzstd_frame(libzstd, a, 1) + skippable(b"skip me") + \
            libzstd_frame(libzstd, b, 19, checksum=True, content_size=False)
        want = a + b
        assert zstd.content_size(frame) is None   # the second has none
    assert zstd.decompress(frame).tobytes() == want


def ts_read_chunk(tmp_path, frame: bytes, size: int) -> bytes:
    """`frame` as the one chunk of a zarr v2 array of `size` bytes, read
    by tensorstore's zarr driver."""
    path = tmp_path / f"raw_{size}"
    path.mkdir()
    (path / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": [size], "chunks": [size], "dtype": "|u1",
        "compressor": {"id": "zstd", "level": 1}, "fill_value": None,
        "filters": None, "order": "C"}))
    (path / "0").write_bytes(frame)
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                                 "path": str(path)}}).result()
    return np.asarray(arr.read().result()).tobytes()


@pytest.mark.parametrize("size", [0, 1, 128 << 10, (128 << 10) + 1,
                                  5_000_000], ids=str)
def test_frame_raw(tmp_path, size):
    """`frame_raw`'s frame of `size` bytes of f32 weights: a content size,
    no checksum, blocks of at most 128 KiB; decoded to the same bytes by
    the port's decoder, by tensorstore (a zarr chunk; an array of 0 bytes
    has no chunk to read) and by libzstd where ctypes finds it."""
    data = make_data("f32", size, seed=size)
    frame = zstd.frame_raw(data)
    blocks = max(1, -(-size // (128 << 10)))
    assert frame[:4] == b"\x28\xb5\x2f\xfd" and not frame[4] & 4
    assert len(frame) == 14 + 3 * blocks + size
    assert zstd.content_size(frame) == size
    assert zstd.decompress(frame).tobytes() == data
    assert zstd.frame_raw(np.frombuffer(data, np.uint8)) == frame
    if size:
        assert ts_read_chunk(tmp_path, frame, size) == data
    lib = _libzstd()
    if lib is not None:
        assert lib.ZSTD_getFrameContentSize(frame, len(frame)) == size
        out = ctypes.create_string_buffer(max(size, 1))
        n = lib.ZSTD_decompress(out, len(out), frame, len(frame))
        assert not lib.ZSTD_isError(n) and out.raw[:n] == data


def test_content_size_of_tensorstore_frames(tmp_path):
    """tensorstore writes streaming frames: the size is the reader's to
    know (zarr's chunk shape), and `decompress` bounds it by the blocks."""
    data = make_data("f16f32", 200_000)
    frame = ts_frame(tmp_path, data, 1)
    assert zstd.content_size(frame) is None
    assert zstd.decompress(frame).tobytes() == data


def test_crc32c():
    assert zstd.crc32c(b"123456789") == 0xE3069283   # the check value
    assert zstd.crc32c(b"") == 0
    data = make_data("int32", 10_001)
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    crc = 0xFFFFFFFF                              # bitwise reference
    for bit in bits:
        crc = (crc >> 1) ^ (0x82F63B78 if (crc ^ int(bit)) & 1 else 0)
    assert zstd.crc32c(data) == crc ^ 0xFFFFFFFF


def _header_edit(frame: bytes, flag: int, insert: bytes = b"") -> bytes:
    """`frame` with bits `flag` set in its frame header descriptor and
    `insert` placed after the window descriptor (a dictionary ID)."""
    fhd = frame[4]
    at = 5 + (0 if fhd & 0x20 else 1)
    return frame[:4] + bytes([fhd | flag]) + frame[5:at] + insert + frame[at:]


CHILD = r"""
import json, sys
import numpy as np
from relativepose_tpu_torch.native import zstd
cases = json.load(open(sys.argv[1]))
out = {}
for name, (frame_hex, want_hex) in cases.items():
    frame, want = bytes.fromhex(frame_hex), bytes.fromhex(want_hex)
    try:
        got = zstd.decompress(frame).tobytes()
        out[name] = "same" if got == want else "different"
    except ValueError as e:
        out[name] = "ValueError: " + str(e)
print(json.dumps(out))
"""


def test_malformed_frames_raise(tmp_path, libzstd):
    """Truncations, bit flips (in frames with a checksum, so that every
    flip is detectable), a dictionary ID and a reserved bit: each raises
    ValueError in a child process, which ends normally."""
    data = make_data("int32", 40_000) + make_data("text", 20_000)
    frames = {"ts": (ts_frame(tmp_path, data, 3), data),
              "sum": (libzstd_frame(libzstd, data, 19, checksum=True), data)}
    cases = {}
    for name, (frame, want) in frames.items():
        for cut in sorted({1, 4, 5, 8, 12, 40, 200, len(frame) // 2,
                           len(frame) - 4, len(frame) - 1}):
            cases[f"{name}-cut{cut}"] = (frame[:cut], want)
    frame = frames["sum"][0]
    rng = np.random.default_rng(0)
    for i in range(400):
        f = bytearray(frame)
        pos = int(rng.integers(0, len(f)))
        f[pos] ^= 1 << int(rng.integers(0, 8))
        cases[f"flip{i}@{pos}"] = (bytes(f), data)
    cases["dictionary"] = (_header_edit(frames["ts"][0], 1, b"\x07"), data)
    cases["reserved"] = (_header_edit(frames["ts"][0], 0x08), data)
    cases["magic"] = (b"\x00" + frames["ts"][0][1:], data)
    path = tmp_path / "cases.json"
    path.write_text(json.dumps({k: (f.hex(), w.hex())
                                for k, (f, w) in cases.items()}))
    zstd.build()   # built once here, not by the child
    proc = subprocess.run([sys.executable, "-c", CHILD, str(path)],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = {k: v for k, v in res.items() if not v.startswith("ValueError")}
    assert not bad, bad
    assert "dictionary" in res["dictionary"]
    assert "reserved" in res["reserved"]
    assert "magic" in res["magic"]
