"""Zstandard frames and CRC-32C: the port's own decoder, and frames of
raw blocks written in Python.

`native/zstd.cpp` is a decode-only Zstandard decoder (RFC 8878) with a
plain C interface, bound here with ctypes.  It is built with g++ at first
use into `relativepose_tpu_torch/build/` (`native/build.py`), so reading
a checkpoint that orbax wrote (`utils/orbax_read.py`) needs no zstd
package.  There is no fallback: without g++ the first call raises.

Malformed input raises `ValueError` with the decoder's reason; the
decoder reads only the input and writes only the output buffer.

`frame_raw` writes the other direction without the library: one valid
frame whose blocks are stored, not compressed (what
`utils/orbax_write.py` puts in a checkpoint's zarr chunks; f32 weights
and Adam moments shrink by a few percent at most under zstd level 1).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from relativepose_tpu_torch.native import build as native_build

SOURCE = Path(__file__).with_name("zstd.cpp")
BUILD_DIR = native_build.BUILD_DIR
CXXFLAGS = native_build.CXXFLAGS

_ERRORS = {
    -1: "input ends inside a frame, or holds no frame",
    -2: "not a zstd frame (bad magic number)",
    -3: "a reserved bit or block type is set",
    -4: "the frame needs a dictionary, which is not supported",
    -5: "corrupt compressed data",
    -6: "output buffer too small",
    -7: "content checksum mismatch",
    -8: "decoded size differs from the frame's content size",
    -10: "out of memory",
}
_UNKNOWN = -9

MAGIC = b"\x28\xb5\x2f\xfd"
RAW_BLOCK_MAX = 128 * 1024   # Block_Maximum_Size, and the frame's window
# Frame_Header_Descriptor: Frame_Content_Size_flag 3 (an 8-byte size), no
# Single_Segment_flag, no checksum, no dictionary; Window_Descriptor:
# exponent 7, mantissa 0, a 2^(10 + 7) = 128 KiB window
_RAW_HEADER = MAGIC + bytes([0xC0, 7 << 3])

_LIB = None
build_seconds = None   # seconds of this process's build, None if none ran


def build() -> Path:
    """Build the decoder unless it is built; returns its path."""
    global build_seconds
    out, seconds = native_build.build(SOURCE, "rpzstd", CXXFLAGS, BUILD_DIR)
    if seconds is not None:
        build_seconds = seconds
    return out


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        for fn in ("rp_zstd_content_size", "rp_zstd_decompress_bound"):
            getattr(lib, fn).argtypes = [p, i64]
            getattr(lib, fn).restype = i64
        lib.rp_zstd_decompress.argtypes = [p, i64, p, i64]
        lib.rp_zstd_decompress.restype = i64
        lib.rp_crc32c.argtypes = [p, i64]
        lib.rp_crc32c.restype = ctypes.c_uint32
        _LIB = lib
    return _LIB


def _bytes(src) -> np.ndarray:
    """A uint8 view of a bytes-like object, without a copy."""
    a = np.frombuffer(src, np.uint8) if not isinstance(src, np.ndarray) \
        else src.reshape(-1).view(np.uint8)
    if not a.flags.c_contiguous:
        raise ValueError("zstd input must be contiguous")
    return a


def _check(code: int) -> int:
    if code < 0:
        raise ValueError(f"zstd: {_ERRORS.get(code, f'error {code}')}")
    return code


def content_size(src):
    """The decoded size the frames declare, or None when one does not."""
    a = _bytes(src)
    n = _load().rp_zstd_content_size(a.ctypes.data, a.size)
    return None if n == _UNKNOWN else _check(n)


def decompress_into(src, out: np.ndarray) -> int:
    """Decode every frame of `src` into the bytes of `out` (a writable,
    C-contiguous array); returns the bytes written."""
    a = _bytes(src)
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("zstd output must be a writable C-contiguous array")
    return _check(_load().rp_zstd_decompress(a.ctypes.data, a.size,
                                             out.ctypes.data, out.nbytes))


def decompress(src) -> np.ndarray:
    """Decode every frame of `src`; returns a uint8 array."""
    a = _bytes(src)
    size = content_size(a)
    if size is None:
        size = _check(_load().rp_zstd_decompress_bound(a.ctypes.data, a.size))
    out = np.empty(size, np.uint8)
    return out[:decompress_into(a, out)]


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a bytes-like object."""
    a = _bytes(data)
    return int(_load().rp_crc32c(a.ctypes.data, a.size))


def frame_raw(data) -> bytes:
    """`data` (a C-contiguous bytes-like object) as one zstd frame of
    Raw_Blocks (Block_Type 0) of at most 128 KiB each, with the frame's
    content size and no checksum.  Each block header is 3 bytes, little
    endian: Last_Block (bit 0), Block_Type (bits 1-2), Block_Size (bits
    3-23).  Empty data is one empty last block."""
    view = memoryview(data).cast("B")
    n = len(view)
    parts = [_RAW_HEADER, struct.pack("<Q", n)]
    for lo in range(0, max(n, 1), RAW_BLOCK_MAX):
        size = min(RAW_BLOCK_MAX, n - lo)
        parts.append(struct.pack("<I", size << 3 | (lo + size == n))[:3])
        parts.append(view[lo:lo + size])
    return b"".join(parts)
