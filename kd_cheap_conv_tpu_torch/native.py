"""Build and load the port's hand-written CUDA kernels.

The sources in `csrc/` are compiled at first use with nvcc into a shared
library with a plain C interface under `build/` (listed in .gitignore) and
loaded with ctypes. The library name carries a hash of the sources, so an
edited kernel is rebuilt and a stale build is never loaded. Nothing here
runs at import time: the CPU tests import every module, and the machine
they run on may have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels are built from source at first use")


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile csrc/*.cu into build/libkdcc_<hash>.so if it is not there.

    Returns (library path, build seconds, nvcc's -Xptxas -v report); the
    seconds are 0.0 and the report empty when the library already existed.
    """
    srcs = _sources()
    digest = hashlib.sha1()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    lib = BUILD_DIR / f"libkdcc_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds, proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    # dtype; x, we, be, kd, bd, wp, bp, y; n, h, w, cin, ce, cout,
    # stride, dil, expand, res, th, tw, ch, smem_bytes, device; stream
    lib.kdcc_ir_block_eval.argtypes = [_I] + [_P] * 8 + [_I] * 15 + [_P]
    lib.kdcc_ir_block_eval.restype = _I
    lib.kdcc_error_string.argtypes = [_I]
    lib.kdcc_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().kdcc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
