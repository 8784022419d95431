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
both, the kernels of the model's paths. `SLAB_FAMILIES` are K4's two
halves, which only the depth-sharded forward runs (`parallel/spatial.py`)
in place of K4. `ENTRY_FAMILIES` are kernels that
only a standalone entry point runs (`phase_split`, as in the JAX package).
Each family also has a float32 form, counted under its name with `_f32`
(`family(name, dtype)`; `F32_FAMILIES`, and `FWD_FAMILIES_F32` and so on):
a CUDA tensor of the compute dtype float32 launches it. The plain versions
are counted under the family's own name whatever the dtype. `FAMILIES` is
every family of both dtypes.
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
SLAB_FAMILIES = ("norm_stats", "norm_apply")
ENTRY_FAMILIES = ("phase_split",)
F32 = "_f32"
FWD_FAMILIES_F32 = tuple(f + F32 for f in FWD_FAMILIES)
BWD_FAMILIES_F32 = tuple(f + F32 for f in BWD_FAMILIES)
PATH_FAMILIES_F32 = FWD_FAMILIES_F32 + BWD_FAMILIES_F32
SLAB_FAMILIES_F32 = tuple(f + F32 for f in SLAB_FAMILIES)
ENTRY_FAMILIES_F32 = tuple(f + F32 for f in ENTRY_FAMILIES)
F32_FAMILIES = PATH_FAMILIES_F32 + SLAB_FAMILIES_F32 + ENTRY_FAMILIES_F32
FAMILIES = PATH_FAMILIES + SLAB_FAMILIES + ENTRY_FAMILIES + F32_FAMILIES
KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # the compute dtypes with kernels
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
    "coma_conv3d_t2": [_P] * 5 + [_I] * 14 + [_P],
    "coma_norm_act": [_P] * 7 + [_I] * 11 + [ctypes.c_float, _P],
    "coma_conv3d_s1_dw": [_P] * 4 + [_I] * 14 + [_P],
    "coma_conv3d_strided_dw": [_P] * 4 + [_I] * 13 + [_P],
    "coma_norm_act_bwd": [_P] * 10 + [_I] * 11 + [_P],
    "coma_hsplit": [_P] * 3 + [_I] * 2 + [_P],
    "coma_norm_stats": [_P] * 4 + [_I] * 4 + [_P],
    "coma_norm_apply": [_P] * 6 + [_I] * 5 + [_P],
    "coma_conv3d_s1_f32_tc": [_P] * 5 + [_I] * 15 + [_P],
    "coma_conv3d_s2_f32_tc": [_P] * 5 + [_I] * 14 + [_P],
    "coma_conv3d_t2_f32_tc": [_P] * 5 + [_I] * 14 + [_P],
    "coma_conv3d_dw_f32_tc": [_P] * 4 + [_I] * 16 + [_P],
    "coma_norm_act_f32": [_P] * 7 + [_I] * 11 + [ctypes.c_float, _P],
    "coma_norm_act_bwd_f32": [_P] * 10 + [_I] * 11 + [_P],
    "coma_hsplit_f32": [_P] * 3 + [_I] * 2 + [_P],
    "coma_norm_stats_f32": [_P] * 4 + [_I] * 4 + [_P],
    "coma_norm_apply_f32": [_P] * 6 + [_I] * 5 + [_P],
    "coma_slab_ctas_per_sm": [_I] * 3,
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
    lib = _lib if _lib is not None else library()
    fn = getattr(lib, entry)
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        msg = lib.coma_error_string(rc).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {rc} ({msg})")
    LAUNCHES[family] += 1


def family(name: str, dtype: torch.dtype) -> str:
    """The counted family of kernel `name` for tensors of `dtype`: the name
    itself for bf16, its float32 form `name_f32` for f32."""
    return name + F32 if dtype == torch.float32 else name


def kernel_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    """The dtype of a CUDA call's tensors, from its first one: bf16 or f32,
    the dtypes with kernels; raise for any other."""
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: the CUDA kernels take bfloat16 or float32, "
                         f"got {t.dtype}")
    return t.dtype


def check_cuda_input(name: str, t: torch.Tensor, ndim: int,
                     device: torch.device, dtype: torch.dtype) -> None:
    """Raise unless t is a contiguous ndim-d tensor of `dtype` on `device`:
    every tensor of a call takes the dtype its call site passes (that of
    its first tensor, or f32 for statistics), and none is cast."""
    if (t.device != device or t.dtype != dtype or t.dim() != ndim
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: the CUDA kernel takes a contiguous {ndim}-d {dtype} "
            f"tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}, contiguous={t.is_contiguous()}")
