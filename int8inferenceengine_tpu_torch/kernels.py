"""Build and bind the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled at first use
with ``nvcc`` into ``_build/lib<name>-<source hash>.so`` (a changed source
gets a new library) and loaded with ``ctypes``.  Nothing here runs at import:
the CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# Never --use_fast_math; --fmad=false keeps every epilogue float op rounded
# on its own, as the reference's are.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong

# source name -> {C function: argtypes}; every function returns a CUDA error code
SIGNATURES = {
    "qgemm_int8": {
        # a, w, oc, ep, out, M, N, K, s_a, s_c, zp_c, conv_order, relu,
        # nearest, act, act_scale, act_zp, tile, slices, kslice, loader,
        # stream (conv_order: an ops/gemm_int8.ORDERS index)
        "qgemm_u8s8": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I,
                       _I, _I, _F, _F, _I, _I, _I, _I, _P],
        # a, w, oc, mult, zp, out, M, N, K, nearest, tile, slices, kslice,
        # loader, stream
        "qgemm_u8s8_vzp": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _P],
        # x, w, oc, ep, out, B, H, W, C, kh, kw, stride, pad, N, zp_a, s_a,
        # s_c, zp_c, conv_order, relu, nearest, tile, slices, kslice, loader,
        # stream
        "qgemm_u8s8_conv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    },
    "decode_attn": {
        # q, k, v, valid, out, B, T, H, Hkv, D, mq, q_sb, q_sj,
        # valid_per_seq, window, softcap, zp_q, zp_k, zp_p, zp_v, mult_s,
        # zp_s, s_s, s_p, zp_p (float), mult_o, zp_c, nearest, mq_tile,
        # splits, share, tiles, stream
        "decode_attn_flat": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L,
                             _L, _I, _I, _F, _I, _I, _I, _I, _F, _F, _F, _F,
                             _F, _F, _F, _I, _I, _I, _I, _I, _P],
    },
    "w4_gemm": {
        # x, packed, scales_t, mult, zpb_eff, out, M, N, K, group, nearest,
        # slices, kslice, stream
        "w4a8_v2_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P],
        # x, packed, scales_t, mult, zpb_eff, out, M, N, K, g, nearest,
        # stream
        "w4a8_v1_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # x, packed, scales, bias, out, M, N, K, g, stream
        "w4_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "conv_grouped": {
        # x, w, oc, ep, out, B, H, W, C, O, groups, kh, kw, stride, pad,
        # zp_a, s_a, s_c, zp_c, relu, nearest, bf16, stream
        "conv_grouped_u8s8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _F, _I, _I, _I, _I,
                              _P],
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=tuple(SIGNATURES)) -> dict[str, Path]:
    """Compile every listed source whose library is missing, one ``nvcc``
    per source, all started together.  The compiler's output (register and
    shared-memory use from ``-Xptxas -v``) goes to ``_build/<name>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    missing = {n: so for n, so in paths.items() if not so.exists()}
    nvcc = _nvcc() if missing else None
    procs = []
    for name, so in missing.items():
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, so, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, so)
        else:
            failed.append(name)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{n}.log").read_text()[-4000:]
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` with its argtypes set."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
