"""NIfTI-1 file I/O in numpy, gzip and struct (counterpart of
`coma_unet_tpu/io/nifti.py`, the same reader and writer; no nibabel or
SimpleITK).

The 348-byte header, the optional gzip container, the data scaling
(scl_slope/scl_inter) and the qform/sform affine of the NIfTI-1 standard.

Array convention: `NiftiImage.data` is indexed [i, j, k] in *file order*
(fastest-varying first axis = x), like nibabel. `data_zyx` gives the
SimpleITK `GetArrayFromImage` view (z, y, x) that the volumes of the data
pipeline use. Spacing is (x, y, z) like sitk `GetSpacing`.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# NIfTI-1 datatype codes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


@dataclass
class NiftiImage:
    data: np.ndarray                       # [i, j, k(, t...)] file-order
    affine: np.ndarray                     # 4x4 voxel->world (RAS)
    spacing: Tuple[float, float, float]    # (x, y, z) voxel size, mm
    header: dict = field(default_factory=dict)

    @property
    def data_zyx(self) -> np.ndarray:
        """SimpleITK-style (z, y, x) array view (what the reference's
        `GetArrayFromImage` produced)."""
        return np.transpose(self.data, (2, 1, 0)) if self.data.ndim == 3 else (
            np.transpose(self.data, tuple(range(self.data.ndim - 1, -1, -1)))
        )

    @property
    def spacing_zyx(self) -> Tuple[float, float, float]:
        return self.spacing[::-1]


def _open_maybe_gz(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> NiftiImage:
    with _open_maybe_gz(path) as f:
        raw = f.read()
    return parse_nifti(raw, path)


def parse_nifti(raw: bytes, path: str = "<bytes>") -> NiftiImage:
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        endian = ">"

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    magic = raw[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = u("8h", 40)
    ndim = int(dim[0])
    shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 1)])
    datatype = u("h", 70)[0]
    bitpix = u("h", 72)[0]
    pixdim = u("8f", 76)
    vox_offset = u("f", 108)[0]
    scl_slope = u("f", 112)[0]
    scl_inter = u("f", 116)[0]
    qform_code = u("h", 252)[0]
    sform_code = u("h", 254)[0]
    quatern = u("6f", 256)   # b, c, d, qoffset_x, y, z
    srow_x = u("4f", 280)
    srow_y = u("4f", 296)
    srow_z = u("4f", 312)

    np_dtype = _DTYPES.get(datatype)
    if np_dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    np_dtype = np.dtype(np_dtype).newbyteorder(endian)

    n_vox = int(np.prod(shape)) if shape else 0
    start = int(vox_offset)
    data = np.frombuffer(raw, dtype=np_dtype, count=n_vox, offset=start)
    data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        data = data.astype(np.float32) * (scl_slope or 1.0) + scl_inter

    spacing = tuple(float(abs(p)) for p in pixdim[1:4])

    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], dtype=np.float64)
    elif qform_code > 0:
        affine = _qform_affine(quatern, pixdim)
    else:
        affine = np.diag(list(spacing) + [1.0]).astype(np.float64)

    header = {
        "datatype": int(datatype),
        "bitpix": int(bitpix),
        "scl_slope": float(scl_slope),
        "scl_inter": float(scl_inter),
        "qform_code": int(qform_code),
        "sform_code": int(sform_code),
        "pixdim": tuple(float(p) for p in pixdim),
    }
    return NiftiImage(
        data=np.asarray(data), affine=affine, spacing=spacing, header=header
    )


def _qform_affine(quatern, pixdim) -> np.ndarray:
    b, c, d, ox, oy, oz = (float(v) for v in quatern)
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    S = np.diag([pixdim[1], pixdim[2], qfac * pixdim[3]])
    aff = np.eye(4)
    aff[:3, :3] = R @ S
    aff[:3, 3] = (ox, oy, oz)
    return aff


def write_nifti(
    path: str,
    data: np.ndarray,
    affine: Optional[np.ndarray] = None,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> None:
    """Write a NIfTI-1 (.nii or .nii.gz) file. `data` in [i, j, k] file
    order; use `np.transpose(zyx, (2,1,0))` for sitk-style arrays."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype.newbyteorder("="))]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    pixdim = [1.0] + list(spacing) + [1.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pixdim[:8])
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    if affine is None:
        affine = np.diag(list(spacing) + [1.0])
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 1)       # sform_code = scanner
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)
