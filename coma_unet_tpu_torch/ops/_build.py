"""Builds the hand-written CUDA kernels of `coma_unet_tpu_torch/csrc` and
launches them.

The sources are compiled at first use with `nvcc` for `sm_90a`, one `nvcc`
per source, all started together, and linked into one shared library with
a plain C interface, under `build/coma_unet_tpu_torch/` at the root of the
checkout, named after a hash of the sources so that an edit rebuilds. The library is loaded with ctypes; every pointer and the
stream pass as `c_void_p`. Each C entry point returns `cudaGetLastError()`
after its launches, and `launch` raises if that is not 0. A missing `nvcc`
or a failed build raises `RuntimeError` with the compiler's output.

The launch counters live here: `LAUNCHES[family]` counts kernel launches,
and `PLAIN_ON_CUDA` / `PLAIN_ON_CPU` count calls of a family's plain PyTorch
version by the device of its input. `FWD_FAMILIES` are the kernels a
forward runs, `BWD_FAMILIES` those only a backward runs (a backward also
launches forward families for its input gradients); `PATH_FAMILIES` is
both, the kernels of the model's paths. `ENTRY_FAMILIES` are kernels that
only a standalone entry point runs (`phase_split`, as in the JAX package);
`FAMILIES` is every family.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

FWD_FAMILIES = ("s1", "s2", "t2", "norm_act")
BWD_FAMILIES = ("s1_dw", "strided_dw", "norm_act_bwd")
PATH_FAMILIES = FWD_FAMILIES + BWD_FAMILIES
ENTRY_FAMILIES = ("phase_split",)
FAMILIES = PATH_FAMILIES + ENTRY_FAMILIES
LAUNCHES: Counter = Counter()
PLAIN_ON_CUDA: Counter = Counter()
PLAIN_ON_CPU: Counter = Counter()

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "coma_unet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int64
# C entry points: name -> argtypes (all return an int cudaError_t)
_SIGNATURES = {
    "coma_conv3d_s1_tc": [_P] * 5 + [_I] * 15 + [_P],
    "coma_conv3d_s2_tc": [_P] * 5 + [_I] * 14 + [_P],
    "coma_conv3d_t2": [_P, _P, _P, _P] + [_I] * 7 + [_P],
    "coma_norm_act": [_P] * 7 + [_I] * 4 + [ctypes.c_float, _P],
    "coma_conv3d_s1_dw": [_P] * 4 + [_I] * 14 + [_P],
    "coma_conv3d_strided_dw": [_P] * 4 + [_I] * 13 + [_P],
    "coma_norm_act_bwd": [_P] * 10 + [_I] * 4 + [_P],
    "coma_hsplit": [_P] * 3 + [_I] * 2 + [_P],
}

_lib = None
_lock = threading.Lock()


def reset_counts() -> None:
    for counter in (LAUNCHES, PLAIN_ON_CUDA, PLAIN_ON_CPU):
        counter.clear()


def count_plain(family: str, x: torch.Tensor) -> None:
    (PLAIN_ON_CUDA if x.is_cuda else PLAIN_ON_CPU)[family] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: nvcc was not found (no CUDA "
            "toolkit under CUDA_HOME or on PATH)")
    return found


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists;
    return its path. Raises RuntimeError with the compiler output on
    failure."""
    cu, headers = _sources()
    digest = hashlib.sha256()
    for path in cu + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libcoma_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{path.stem}.{tag}.o" for path in cu]
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o", str(obj),
             str(src)] for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    link = [nvcc, "-shared", "-gencode", NVCC_FLAGS[1], "-o", str(tmp),
            *map(str, objs)]
    rcs = [proc.returncode for proc in procs]
    if not any(rcs):
        proc = subprocess.run(link, capture_output=True, text=True)
        cmds.append(link)
        outs.append(proc.stdout + proc.stderr)
        rcs.append(proc.returncode)
    log = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, out in zip(cmds, outs))
    (BUILD_DIR / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if any(rcs):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({max(rcs)}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.coma_error_string.argtypes = [ctypes.c_int]
            lib.coma_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for a missing one."""
    return None if t is None else t.data_ptr()


def launch(family: str, entry: str, device: torch.device, *args) -> None:
    """Call a C entry point on the current stream of `device` and count one
    launch of `family`; raise RuntimeError if it reports a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.coma_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")
    LAUNCHES[family] += 1


def check_cuda_input(name: str, t: torch.Tensor, ndim: int,
                     device: torch.device, dtype=torch.bfloat16) -> None:
    if (t.device != device or t.dtype != dtype or t.dim() != ndim
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: the CUDA kernel takes a contiguous {ndim}-d {dtype} "
            f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}, contiguous={t.is_contiguous()}")
