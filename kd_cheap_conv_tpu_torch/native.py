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
_F = ctypes.c_float


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


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
    for s in srcs + _headers():
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    lib = BUILD_DIR / f"libkdcc_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest.hexdigest()[:12]}.{os.getpid()}"
    t0 = time.perf_counter()
    # one nvcc per source, all at once, then one link
    jobs = []
    for s in srcs:
        obj = BUILD_DIR / f"{s.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", "-o", str(obj), str(s)]
        jobs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for s, _, proc in jobs:
        _, err = proc.communicate()
        log.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {s.name} ({proc.returncode}):\n"
                          f"{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, "".join(log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    # x, we, be, kd, bd, wp, bp, y; n, h, w, cin, ce, cout, stride, dil,
    # expand, res, th, tw, ch, smem_bytes, device; stream (float32); the
    # bf16 entry adds wn, resident, grid after ch
    lib.kdcc_ir_block_eval.argtypes = [_P] * 8 + [_I] * 15 + [_P]
    lib.kdcc_ir_block_eval.restype = _I
    lib.kdcc_ir_block_eval_bf16.argtypes = [_P] * 8 + [_I] * 18 + [_P]
    lib.kdcc_ir_block_eval_bf16.restype = _I
    # dtype; s, t, labels, lo_y, fy, lo_x, fx, tb_y, tb_x, out, partials,
    # ticket; n, c, h, w, H, W; inv_t, clip; ignore, with_kl, reg_h, reg_w,
    # grid, smem_bytes; stream
    lib.kdcc_ce_kl_up_fwd.argtypes = ([_I] + [_P] * 12 + [_I] * 6 + [_F] * 2
                                      + [_I] * 6 + [_P])
    lib.kdcc_ce_kl_up_fwd.restype = _I
    # dtype; s, t, labels, lo_y, fy, ob_y, oe_y, lo_x, fx, ob_x, oe_x,
    # scales, ds; n, c, h, w, H, W; inv_t, clip; ignore, with_kl, win_h,
    # win_w, reg_h, reg_w, rows, smem_bytes; stream
    lib.kdcc_ce_kl_up_bwd.argtypes = ([_I] + [_P] * 13 + [_I] * 6 + [_F] * 2
                                      + [_I] * 8 + [_P])
    lib.kdcc_ce_kl_up_bwd.restype = _I
    # dtype; x, bn, w, y, partial; P, ci, co, relu; eps; grid, smem; stream
    lib.kdcc_bn_pw_fwd.argtypes = [_I] + [_P] * 5 + [_I] * 4 + [_F] \
        + [_I] * 2 + [_P]
    # what, P, ci, co
    lib.kdcc_bn_pw_fwd_plan.argtypes = [_I] * 4
    lib.kdcc_bn_pw_fwd_plan.restype = _I
    # x, bn, w, y, scratch, moments, tickets; P, ci, co, relu; eps; grid,
    # scratch_floats; stream
    lib.kdcc_bn_pw_fwd_bf16.argtypes = [_P] * 7 + [_I] * 4 + [_F] + [_I] * 2 \
        + [_P]
    # dtype; x, bn, k, y, scratch, moments, tickets; n, h, w, c, stride,
    # dil, relu; eps; grid, scratch_floats; stream
    lib.kdcc_bn_dw_fwd.argtypes = [_I] + [_P] * 7 + [_I] * 7 + [_F] \
        + [_I] * 2 + [_P]
    # what, dtype, n, h, w, c, stride, dil
    lib.kdcc_bn_dw_fwd_plan.argtypes = [_I] * 8
    lib.kdcc_bn_dw_fwd_plan.restype = _I
    # dtype; gy, an, pn, ak, bnk, w, gyk, psum, pw; P, ci, co, relu; eps;
    # grid, smem; stream
    lib.kdcc_pw_bwd.argtypes = [_I] + [_P] * 9 + [_I] * 4 + [_F] + [_I] * 2 \
        + [_P]
    # what, P, ci, co, has_pn
    lib.kdcc_pw_bwd_plan.argtypes = [_I] * 5
    lib.kdcc_pw_bwd_plan.restype = _I
    # gy, an, pn, ak, bnk, w, gyk, dw, sums, scratch, tickets; P, ci, co,
    # relu; eps; scratch_floats; stream
    lib.kdcc_pw_bwd_bf16.argtypes = [_P] * 11 + [_I] * 4 + [_F, _I, _P]
    # dtype; gy, an, pn, ak, bnk, k, gyk, psum, pk; n, h, w, c, stride,
    # dil, relu; eps; grid; stream
    lib.kdcc_dw_bwd.argtypes = [_I] + [_P] * 9 + [_I] * 7 + [_F, _I, _P]
    # dtype, n, h, w, c, stride, dil
    lib.kdcc_dw_bwd_grid.argtypes = [_I] * 7
    lib.kdcc_dw_bwd_grid.restype = _I
    # kernel, dtype, P, ci, co
    lib.kdcc_xpw_grid.argtypes = [_I] * 5
    lib.kdcc_xpw_grid.restype = _I
    # dtype; x, bn, w, y, partial, sums, tickets; P, ci, co, relu; eps;
    # grid; stream
    lib.kdcc_xpw_fwd.argtypes = [_I] + [_P] * 7 + [_I] * 4 + [_F, _I, _P]
    # dtype; gy, an, pn, ak, bnk, w, gyk, psum; P, ci, co, relu; eps; grid;
    # stream
    lib.kdcc_xpw_dgrad.argtypes = [_I] + [_P] * 8 + [_I] * 4 + [_F, _I, _P]
    # dtype; gy, an, pn, ak, bnk, out, scratch, tickets; P, ci, co, relu;
    # eps; splits; stream
    lib.kdcc_xpw_wgrad.argtypes = [_I] + [_P] * 8 + [_I] * 4 + [_F, _I, _P]
    # dtype; x, w, y, partial; n, h, w, c0, grid; stream
    lib.kdcc_f0_fwd.argtypes = [_I] + [_P] * 4 + [_I] * 5 + [_P]
    # dtype; gy, a0, x, pn, partial; n, h, w, c0; eps; grid; stream
    lib.kdcc_f0_wgrad.argtypes = [_I] + [_P] * 5 + [_I] * 4 + [_F] + [_I] \
        + [_P]
    # dtype; gy, a0, pn, w, dx; n, h, w, c0; eps; stream
    lib.kdcc_f0_xgrad.argtypes = [_I] + [_P] * 5 + [_I] * 4 + [_F] + [_P]
    # dtype; x, w, bias, y; n, h, w, grid, smem; stream
    lib.kdcc_tstem.argtypes = [_I] + [_P] * 4 + [_I] * 5 + [_P]
    # kernel, dtype, n, h, w
    lib.kdcc_head_grid.argtypes = [_I] * 5
    lib.kdcc_head_grid.restype = _I
    # dtype; x0, x1, dwt, pw, y, partial; n, h, w, c0, c1, co, k, dil, grid;
    # stream
    lib.kdcc_sep_fwd.argtypes = [_I] + [_P] * 6 + [_I] * 9 + [_P]
    # dtype; a, bn, wc, bc, y; P, cm, nc; eps; grid; stream
    lib.kdcc_head_fwd.argtypes = [_I] + [_P] * 5 + [_I] * 3 + [_F, _I, _P]
    # dtype; g, a, bn, wc, gu, psum, pwc, pbc; P, cm, nc; eps; grid; stream
    lib.kdcc_head_bwd.argtypes = [_I] + [_P] * 8 + [_I] * 3 + [_F, _I, _P]
    # what, P, cm, nc
    lib.kdcc_head_bwd_plan.argtypes = [_I] * 4
    lib.kdcc_head_bwd_plan.restype = _I
    # g, a, bn, wc, gu, dwc, sums, dbc, scratch, tickets; P, cm, nc; eps;
    # grid, scratch_floats; stream
    lib.kdcc_head_bwd_bf16.argtypes = [_P] * 10 + [_I] * 3 + [_F] + [_I] * 2 \
        + [_P]
    lib.kdcc_head_bwd_bf16.restype = _I
    # dtype; gu, a, x0, x1, pn, dwt, pwt, gx0, gx1, pdpw, pdk; n, h, w, c0,
    # c1, cm; eps; grid; stream
    lib.kdcc_sep_bwd.argtypes = [_I] + [_P] * 11 + [_I] * 6 + [_F, _I, _P]
    # what, n, h, w, c0, c1, cm
    lib.kdcc_sep_bwd_plan.argtypes = [_I] * 7
    lib.kdcc_sep_bwd_plan.restype = _I
    # gu, a, x0, x1, pn, k, pw, gx0, gx1, dpw, dk, scratch, tickets; n, h, w,
    # c0, c1, cm; eps; grid, scratch_floats; stream
    lib.kdcc_sep_bwd_bf16.argtypes = [_P] * 13 + [_I] * 6 + [_F] + [_I] * 2 \
        + [_P]
    # dtype; x, rows, rw, cols, cw, y; n, hi, wi, ho, wo, c; stream
    lib.kdcc_up_fwd.argtypes = [_I] + [_P] * 6 + [_I] * 6 + [_P]
    # dtype; g, rlist, rlw; lr; clist, clw; lc; gx; n, hi, wi, ho, wo, c;
    # stream
    lib.kdcc_up_bwd.argtypes = ([_I] + [_P] * 3 + [_I] + [_P] * 2 + [_I, _P]
                                + [_I] * 6 + [_P])
    # dtype; x, taps, y; n, h, w, c, k, dil, flip; stream
    lib.kdcc_dw_conv.argtypes = [_I] + [_P] * 3 + [_I] * 7 + [_P]
    # dtype; x, g, dk, scratch, tickets; n, h, w, c, k, dil, grid;
    # scratch_floats; stream
    lib.kdcc_dw_dk.argtypes = [_I] + [_P] * 5 + [_I] * 7 \
        + [ctypes.c_longlong, _P]
    # dtype; x, w1, b1, w2, b2, w3, b3, wd, bd, y; n, h, w, c, cm, co, th,
    # tw, nc, smem; stream
    lib.kdcc_bneck_eval.argtypes = [_I] + [_P] * 10 + [_I] * 10 + [_P]
    # s_dt, t_dt; s, t, labels, partials; n, c, hw, t_cs, t_ps; temp, clip;
    # ignore; stream
    lib.kdcc_ce_kl_fwd.argtypes = [_I] * 2 + [_P] * 4 + [_I] * 5 + [_F] * 2 \
        + [_I, _P]
    # s_dt, t_dt; s, t, labels, scales, ds; n, c, hw, t_cs, t_ps; temp,
    # clip; ignore; stream
    lib.kdcc_ce_kl_bwd.argtypes = [_I] * 2 + [_P] * 5 + [_I] * 5 + [_F] * 2 \
        + [_I, _P]
    # x, taps, w, b, x0, wsk, bsk, y; n, h, w, ci, co, c0, dil, pre_relu,
    # residual, final_relu; stream
    lib.kdcc_xsep_eval.argtypes = [_P] * 8 + [_I] * 10 + [_P]
    # in_dt; x, taps, t; n, h, w, ci, dil, pre_relu; stream
    lib.kdcc_xsep_dw.argtypes = [_I] + [_P] * 3 + [_I] * 6 + [_P]
    # out_dt; t, w, b, x0, wsk, bsk, y; P, ci, co, c0, residual,
    # final_relu; stream
    lib.kdcc_xsep_mm.argtypes = [_I] + [_P] * 7 + [_I] * 6 + [_P]
    for fn in (lib.kdcc_bn_pw_fwd, lib.kdcc_bn_dw_fwd, lib.kdcc_pw_bwd,
               lib.kdcc_pw_bwd_bf16, lib.kdcc_dw_bwd, lib.kdcc_f0_fwd,
               lib.kdcc_f0_wgrad, lib.kdcc_f0_xgrad, lib.kdcc_tstem, lib.kdcc_sep_fwd,
               lib.kdcc_head_fwd, lib.kdcc_head_bwd, lib.kdcc_sep_bwd,
               lib.kdcc_up_fwd, lib.kdcc_up_bwd, lib.kdcc_dw_conv,
               lib.kdcc_dw_dk, lib.kdcc_bneck_eval, lib.kdcc_ce_kl_fwd,
               lib.kdcc_ce_kl_bwd, lib.kdcc_xpw_fwd, lib.kdcc_xpw_dgrad,
               lib.kdcc_xpw_wgrad, lib.kdcc_xsep_eval, lib.kdcc_xsep_dw,
               lib.kdcc_xsep_mm):
        fn.restype = _I
    lib.kdcc_error_string.argtypes = [_I]
    lib.kdcc_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().kdcc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
