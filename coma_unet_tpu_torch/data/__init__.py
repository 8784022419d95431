"""The data pipeline of the port (counterpart of `coma_unet_tpu/data/`):
lookup CSVs, covariate and prediction tables, datasets, the threaded
loader, the split orchestration and the cohort presets, read and written
with the standard library, numpy and the native NIfTI reader."""

from coma_unet_tpu_torch.data.covariates import (  # noqa: F401
    CovariateTable,
    PredictionTable,
    QuartileTable,
)
from coma_unet_tpu_torch.data.datasets import (  # noqa: F401
    A4VolumeDataset,
    ClusterVolumeDataset,
    CombinedVolumeDataset,
    ContrastiveVolumeDataset,
    CovariateVolumeDataset,
    CustomSampler,
    InferenceVolumeDataset,
    PredictedMetaTauDataset,
    RegressionVolumeDataset,
    VolumeDataset,
)
from coma_unet_tpu_torch.data.lookup import (  # noqa: F401
    INVALID_IDS,
    create_splits_lookup_tables,
    extract_id,
    filter_for_holdout,
    get_id_from_path,
    load_lookup_csv,
    remove_invalid,
)
from coma_unet_tpu_torch.data.pipeline import (  # noqa: F401
    DataLoader,
    batch_to_device,
    collate,
    compact_roi_np,
    pin_batch,
)
