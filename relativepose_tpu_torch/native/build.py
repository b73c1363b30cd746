"""Builds the port's native C++ libraries with g++ at first use.

A library is one C++ source built with `g++ <flags> -shared` into a build
directory (the ignored `relativepose_tpu_torch/build/`).  Its name carries
a hash of the source, the flags and the processor (`-march=native` builds
for the processor it runs on), so an edited source or another machine gets
a build of its own.  The build writes a temporary file and renames it into
place, so processes that build at the same time each get a whole library.
There is no fallback: without g++ (or `$CXX`) a build raises.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG / "build"
# cpp/Makefile's CXXFLAGS, plus -shared as its rule adds
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")


def _processor() -> bytes:
    """The processor's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return platform.processor().encode()


def lib_path(source: Path, name: str, flags=CXXFLAGS,
             build_dir: Path = BUILD_DIR) -> Path:
    """Where `source` built with `flags` lives: `lib<name>-<hash>.so`."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()
                            + _processor()).hexdigest()[:16]
    return Path(build_dir) / f"lib{name}-{digest}.so"


def build(source: Path, name: str, flags=CXXFLAGS,
          build_dir: Path = BUILD_DIR):
    """Build the library unless it is built.  Returns (path, seconds of
    this call's build, or None when it was already built)."""
    out = lib_path(source, name, flags, build_dir)
    if out.exists():
        return out, None
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: set CXX or put g++ on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *flags, "-shared", "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0
