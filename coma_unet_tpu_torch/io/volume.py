"""Volume loading and writing on the host (counterpart of
`coma_unet_tpu/io/volume.py`).

  * `read_image_with_retry`: N retries with a pause, for flaky network
    file systems.
  * `load_nifti_vol`: read -> resample to 2 mm iso (nearest neighbour by
    default) -> float32, NaN -> 0, a channel dim in front.
  * `write_tensor_to_nii`: an array or tensor -> NIfTI.
  * `pad_volume`, `load_template`: center pad/crop to the model's shape.
  * `mask_volume`, `reduce_image_size`: zero outside a mask; crop to the
    nonzero bounding box.
  * `convert_npy_to_nii`: a saved .npy array -> NIfTI.

Arrays are (z, y, x) like SimpleITK's `GetArrayFromImage`, with the channel
dim in front: [1, D, H, W].
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from coma_unet_tpu_torch.io.nifti import NiftiImage, read_nifti, write_nifti
from coma_unet_tpu_torch.ops.preprocess import center_pad_crop
from coma_unet_tpu_torch.ops.resize import resize_linear, resize_nearest

log = logging.getLogger(__name__)


def read_image_with_retry(path: str, max_retries: int = 10,
                          retry_delay: float = 10.0) -> NiftiImage:
    err: Optional[Exception] = None
    for attempt in range(max_retries):
        try:
            return read_nifti(path)
        except (OSError, ValueError) as e:
            err = e
            if attempt < max_retries - 1:
                log.warning("read %s failed (%s); retry %d/%d", path, e,
                            attempt + 1, max_retries)
                time.sleep(retry_delay)
    raise IOError(f"failed to read {path} after {max_retries} retries") from err


def load_nifti_vol(path: str, resize: bool = True,
                   new_spacing: Sequence[float] = (2.0, 2.0, 2.0),
                   interpolation: str = "nearest", max_retries: int = 10,
                   retry_delay: float = 10.0) -> np.ndarray:
    """A NIfTI file as a [1, D, H, W] float32 (z, y, x) array, resampled
    to `new_spacing` (x, y, z) when `resize`, NaN -> 0."""
    img = read_image_with_retry(path, max_retries, retry_delay)
    vol = img.data_zyx.astype(np.float32)
    if resize:
        resample = resize_nearest if interpolation == "nearest" else resize_linear
        vol = resample(vol, img.spacing_zyx, new_spacing[::-1])
    vol = np.nan_to_num(vol, copy=False)
    return vol[None]


def write_tensor_to_nii(tensor, path: str,
                        spacing: Tuple[float, float, float] = (2.0, 2.0, 2.0)
                        ) -> None:
    """A [1, D, H, W], [1, 1, D, H, W] or [D, H, W] (z, y, x) array or
    tensor -> a NIfTI file."""
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().float().cpu().numpy()
    arr = np.asarray(tensor)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 5:
        arr = arr[0, 0]
    write_nifti(path, np.transpose(arr, (2, 1, 0)), spacing=spacing)


def pad_volume(target: Sequence[int] = (128, 128, 128)) -> Callable:
    """A function that center pads/crops the trailing 3 dims to `target`."""
    tgt = tuple(target)

    def _apply(vol: np.ndarray) -> np.ndarray:
        return center_pad_crop(vol, tgt)

    return _apply


def mask_volume(vol: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """A copy of `vol`, zero where `mask` == 0."""
    out = vol.copy()
    out[mask == 0] = 0
    return out


def load_template(path: str, target: Sequence[int] = (128, 128, 128),
                  resize: bool = True) -> np.ndarray:
    """A template-space ROI mask resized and padded to `target`:
    [D, H, W]."""
    vol = load_nifti_vol(path, resize=resize)
    return center_pad_crop(vol[0], tuple(target))


def reduce_image_size(vol: np.ndarray) -> np.ndarray:
    """[..., D, H, W] cropped to the bounding box of the voxels that are
    nonzero in any leading index; unchanged when every voxel is zero."""
    arr = np.asarray(vol)
    spatial = arr.reshape((-1,) + arr.shape[-3:]).any(axis=0)
    if not spatial.any():
        return arr
    sl = tuple(slice(int(i.min()), int(i.max()) + 1) for i in np.nonzero(spatial))
    return arr[(Ellipsis,) + sl]


def convert_npy_to_nii(npy_path: str, nii_path: str,
                       spacing=(2.0, 2.0, 2.0)) -> None:
    """The array saved at `npy_path` (as `write_tensor_to_nii` takes it)
    written as the NIfTI file `nii_path`."""
    write_tensor_to_nii(np.load(npy_path), nii_path, spacing=spacing)
