"""The native NIfTI reader (counterpart of `coma_unet_tpu/runtime/native.py`):
`nifti_native.cc`, bound with ctypes.

It reads, resamples to 2 mm and center pads/crops a volume, or a list of
them on a pool of C++ threads, outside Python's interpreter lock, and gives
what the numpy reader gives (`io/volume.py:load_nifti_vol` then
`ops/preprocess.py:center_pad_crop`), which stays as its plain version.

The library is built with `g++` at first use into `build/coma_unet_tpu_torch/`
at the root of the checkout, named after a hash of the source and the
command, written under a temporary name and moved into place, so that
processes and threads building at once never load a half-written file. It
links the zlib that Python's own `zlib` module loads; no zlib header is
needed. A build or load that fails raises RuntimeError with the compiler's
output: there is no fallback to the numpy reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().with_name("nifti_native.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "coma_unet_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")
SPACING = 2.0  # mm: what every volume is resampled to, as the numpy reader's default

_F32P = ctypes.POINTER(ctypes.c_float)
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _zlib_args() -> list:
    """Link arguments for the zlib shared library that this process already
    maps (Python's `zlib` module loads it), by soname."""
    import zlib  # noqa: F401  (maps libz into the process)

    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "/libz.so" in line}
    dirs = sorted({os.path.dirname(p) for p in paths})
    return [f"-L{d}" for d in dirs] + ["-l:libz.so.1"]


def build() -> Path:
    """Compile the reader unless a library of the same source and command
    exists; return its path. Raises RuntimeError with the compiler's output
    on failure."""
    link = _zlib_args()
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join((CXX, *CXX_FLAGS, *link, platform.machine())).encode())
    lib_path = BUILD_DIR / f"libcoma_nifti_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"cannot build the native NIfTI reader: {CXX} was "
                           f"not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp), *link]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native NIfTI reader failed "
                           f"({proc.returncode}):\n$ {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The reader's library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading the native NIfTI reader {path} "
                                   f"failed: {e}") from e
            lib.coma_nifti_load_batch.restype = ctypes.c_int
            lib.coma_nifti_load_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, _F32P,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_double, ctypes.c_int, ctypes.c_int]
            _lib = lib
    return _lib


def _target(target: Sequence[int]) -> tuple:
    dims = tuple(int(t) for t in target)
    if len(dims) != 3 or min(dims) <= 0:
        raise ValueError(f"target must be 3 positive sizes, got {target!r}")
    return dims


def load_volume_native(path: str, target: Sequence[int] = (128, 128, 128),
                       resize: bool = True) -> np.ndarray:
    """One NIfTI file -> [1, D, H, W] float32 (z, y, x), resampled to
    SPACING mm when `resize` and center padded/cropped to `target`.
    Raises IOError for a file it cannot read."""
    return load_batch_native([path], target, resize, num_threads=1)[:1]


def load_batch_native(paths: Sequence[str],
                      target: Sequence[int] = (128, 128, 128),
                      resize: bool = True, num_threads: int = 0) -> np.ndarray:
    """NIfTI files -> [N, D, H, W] float32, read on `num_threads` C++
    threads (0: one a core, at most one a file). Raises IOError naming the
    files it cannot read."""
    tz, ty, tx = _target(target)
    lib = library()
    out = np.empty((len(paths), tz, ty, tx), np.float32)
    status = np.zeros(len(paths), np.int32)
    if not len(paths):
        return out
    packed = b"".join(os.fsencode(p) + b"\0" for p in paths)
    failures = lib.coma_nifti_load_batch(
        packed, len(paths), out.ctypes.data_as(_F32P),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), tz, ty, tx,
        SPACING, int(bool(resize)), int(num_threads))
    if failures:
        bad = [str(p) for p, s in zip(paths, status) if s != 0]
        raise IOError(f"native NIfTI load failed for {len(bad)} of "
                      f"{len(paths)} files: {bad}")
    return out
