"""NIfTI I/O and volume loading of the port (counterpart of
`coma_unet_tpu/io/`), numpy only."""

from coma_unet_tpu_torch.io.nifti import (  # noqa: F401
    NiftiImage,
    read_nifti,
    write_nifti,
)
from coma_unet_tpu_torch.io.volume import (  # noqa: F401
    convert_npy_to_nii,
    load_nifti_vol,
    load_template,
    mask_volume,
    pad_volume,
    read_image_with_retry,
    reduce_image_size,
    write_tensor_to_nii,
)
