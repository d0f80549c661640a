"""Builds the port's CUDA kernels from ``fthmc_tpu_torch/csrc`` at first use,
binds them with ctypes, and keeps the launch counters.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library's file name carries a digest of the sources and
flags, so a changed source is rebuilt and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all at once.

Counters: every kernel wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and every plain PyTorch twin adds one to
``PLAIN_CALLS[name]``; ``reset_counts`` zeroes both.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "PLAIN_CALLS", "KERNELS", "SOURCES", "reset_counts",
           "build_all", "library", "bind", "check", "stream_handle",
           "require_fp32_contiguous", "ptr_array", "int_array"]

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("force", "coupling_fwd", "coupling_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("K1", "K6", "K7", "K8")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PP, _IP = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
# argtypes of every C entry, by library
_SIGNATURES = {
    "force": {"k1_force": [_P, _P, _I, _I, _F, _P]},
    "coupling_fwd": {"ft_coupling_forward": [_P, _P, _P, _PP, _I, _I, _I, _IP,
                                             _PP, _PP, _I, _I, _F, _I, _I, _I,
                                             _P],
                     # shared-memory queries (csrc/coupling_common.cuh)
                     "ft_smem_bytes": [_I, _IP, _I], "ft_smem_limit": [_I]},
    "coupling_bwd": {"k8_coupling_bwd": [_P, _P, _P, _P, _PP, _P, _P, _P, _I,
                                         _I, _I, _IP, _PP, _I, _I, _F, _I, _I,
                                         _I, _P]},
}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


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
    return lib


def check(rc: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise if a C entry returned a CUDA error (a launch refused for its
    size never runs, and a later synchronize does not report it)."""
    if rc != 0:
        msg = lib.ft_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_fp32_contiguous(what: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous fp32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: kernels take float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: kernels take contiguous tensors")


def ptr_array(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (``void* const*``)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)
