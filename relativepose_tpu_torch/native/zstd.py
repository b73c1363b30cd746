"""Zstandard decompression and CRC-32C through the port's own decoder.

`native/zstd.cpp` is a decode-only Zstandard decoder (RFC 8878) with a
plain C interface, bound here with ctypes.  It is built with g++ at first
use into `relativepose_tpu_torch/build/` (`native/build.py`), so reading
a checkpoint that orbax wrote (`utils/orbax_read.py`) needs no zstd
package.  There is no fallback: without g++ the first call raises.

Malformed input raises `ValueError` with the decoder's reason; the
decoder reads only the input and writes only the output buffer.
"""

from __future__ import annotations

import ctypes
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
