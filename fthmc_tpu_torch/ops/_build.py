"""Builds the port's CUDA kernels from ``fthmc_tpu_torch/csrc`` at first use,
binds them with ctypes, and keeps the launch counters.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library's file name carries a digest of the sources and
flags, so a changed source is rebuilt and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all at once.

Counters: every kernel wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and every plain PyTorch twin adds one to
``PLAIN_CALLS[name]``; the coupling kernels' launches also add the conv
multiply-adds they run to ``CONV_MACS[name]`` (reckoned on the host,
``coupling_kernels.launch_macs``); ``reset_counts`` zeroes all three.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "PLAIN_CALLS", "CONV_MACS", "KERNELS", "SOURCES",
           "reset_counts", "build_all", "library", "bind", "check",
           "smem_limit", "sm_count", "stream_handle",
           "require_fp32_contiguous", "require_contiguous", "ptr_array",
           "int_ptrs", "int_array"]

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("force", "coupling_fwd", "coupling_bwd", "leapfrog", "hmc_traj",
           "fermion")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# K11_bf16: K11's bf16 instance, the mixed-precision CG's inner solve; K12
# the plain HMC step's epilogue
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
           "K11", "K11_bf16", "K12")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
CONV_MACS = dict.fromkeys(("K6", "K7", "K8"), 0)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
# (B, L, beta, dt, dt / 2, nstep) of every trajectory entry, then the band
# plan (C, row0, threads, sites), K3's tile, and the stream
_TRAJ = [_I, _I, _F, _F, _F, _I]
_BAND = [_I, _IP, _I, _I]
_K11 = [_P] * 8 + [_I, _I, _I, _F, _F, _I, _F, _I, _I, _IP, _I, _I, _P]
# argtypes of every C entry, by library (each library also carries
# ft_error_string and ft_smem_limit of csrc/common.cuh, bound in ``bind``)
_SIGNATURES = {
    # K1: (x, f, B, L, beta, rows, threads, sites, stream); a CTA's shared
    # memory
    "force": {"k1_force": [_P, _P, _I, _I, _F, _I, _I, _I, _P],
              "force_smem_bytes": [_I] * 4},
    # ... (C, row0, limit, stream) ending the coupling entries: the band
    # plan and the card's shared-memory limit
    "coupling_fwd": {"ft_coupling_forward": [_P, _P, _P, _PP, _P, _I, _I, _I,
                                             _IP, _PP, _I, _I, _F, _I, _I,
                                             _I, _I, _IP, _I, _P],
                     # a CTA's shared memory and device scratch
                     # (csrc/coupling_common.cuh)
                     "ft_smem_bytes": [_I, _IP, _I, _I, _I],
                     "ft_band_floats": [_I, _IP, _I, _I, _I]},
    "coupling_bwd": {"k8_coupling_bwd": [_P, _P, _P, _P, _PP, _P, _I, _I, _I,
                                         _IP, _PP, _I, _I, _F, _I, _I, _I,
                                         _I, _IP, _I, _P]},
    "leapfrog": {"k2_leapfrog": [_P] * 4 + _TRAJ + _BAND + [_P],
                 "k3_leapfrog_cl": [_P] * 4 + _TRAJ + _BAND + [_I, _P],
                 # a band-body CTA's shared memory (csrc/traj_common.cuh)
                 "traj_band_smem_bytes": [_I] * 6},
    "hmc_traj": {"k4_hmc_traj": [_P] * 5 + _TRAJ + _BAND + [_P],
                 "k5_hmc_traj_hostrng": [_P] * 6 + _TRAJ + _BAND + [_P],
                 "traj_band_smem_bytes": [_I] * 6,
                 # K12: (x, x1, v1, v0, u, q_old, xo, out, B, L, beta, the
                 # band plan, stream); a CTA's shared memory
                 "k12_hmc_epilogue": [_P] * 8 + [_I, _I, _F] + _BAND + [_P],
                 # ... above the band plans' reach: (C, row0) of the bands
                 "k12_hmc_epilogue_wide": [_P] * 8 + [_I, _I, _F, _I, _IP,
                                                      _P],
                 "epilogue_smem_bytes": [_I] * 4},
    # (pointers, B, L0, L1, a, b, eo, C, row0, [tile,] stream) of the
    # operators: the band plan, and K10's chain tile
    "fermion": {"k9_mdagm": [_P] * 5 + [_I, _I, _I, _F, _F, _I, _I, _IP,
                                        _P],
                "k10_mdagm_cl": [_P] * 5 + [_I, _I, _I, _F, _F, _I, _I, _IP,
                                            _I, _P],
                # (pointers, B, L0, L1, a, b, eo, tol, maxiter, C, row0,
                # threads, cl, stream) of the whole CG solve, fp32 and bf16
                "k11_cg_solve": _K11,
                "k11_cg_solve_bf16": _K11,
                # a CTA's band (csrc/fermion.cu, OpLayout), K11's (CgLayout,
                # by its element's bytes)
                "fermion_smem_bytes": [_I] * 5,
                "cg_smem_bytes": [_I] * 7},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in CONV_MACS:
        CONV_MACS[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process each, all started together. Returns {name: ptxas report} of the
    libraries it compiled; raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = bind(ctypes.CDLL(str(path)), name)
        _LIBS[name] = lib
    return lib


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the argument and result types of the library's entries."""
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ft_error_string.argtypes = [ctypes.c_int]
    lib.ft_error_string.restype = ctypes.c_char_p
    lib.ft_smem_limit.argtypes = [ctypes.c_int]
    lib.ft_smem_limit.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def smem_limit(device_index: int) -> int:
    """Dynamic shared memory one block may opt in to on a CUDA device, as
    the kernels' libraries read it (``ft_smem_limit``)."""
    limit = library("force").ft_smem_limit(device_index)
    if limit < 0:
        raise RuntimeError(f"cannot read the shared memory limit of "
                           f"cuda:{device_index}")
    return limit


@lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (the band plans fill
    them)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(rc: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise if a C entry returned a CUDA error (a launch refused for its
    size never runs, and a later synchronize does not report it)."""
    if rc != 0:
        msg = lib.ft_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream of ``t``'s device, by the raw query
    torch's own generated kernels use: every wrapper call pays for this,
    and ``torch.cuda.current_stream`` builds a Stream object each time."""
    index = t.device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def require_fp32_contiguous(what: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous fp32 tensors on one CUDA device."""
    require_contiguous(what, torch.float32, *tensors)


def require_contiguous(what: str, dtype: torch.dtype,
                       *tensors: torch.Tensor) -> None:
    """Contiguous tensors of ``dtype`` on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{what}: kernels take {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: kernels take contiguous tensors")


def ptr_array(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (``void* const*``)."""
    return int_ptrs([t.data_ptr() for t in tensors])


def int_ptrs(addresses) -> ctypes.Array:
    """A C array of device addresses given as ints (``void* const*``)."""
    return (ctypes.c_void_p * len(addresses))(*addresses)


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)
