"""The model, loss, training, data and experiment configurations.

The port's own copy of the JAX package's configuration
(`coma_unet_tpu/config.py`): the same dataclasses with the same field
names, defaults and `ExperimentConfig.normalized()` semantics, so that one
experiment description drives either package, with the same JSON round
trip (`ExperimentConfig.to_json` / `from_json`, the CLI's `--config`) and
the same ROI names (the keys of the prediction tables).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# The 36 Braak-region FreeSurfer ROI labels of native-space volumes.
ROI_INDICES: Tuple[int, ...] = (
    1001, 1006, 1007, 1009, 1015, 1016, 1030, 1034, 1033, 1008, 1025, 1029,
    1031, 1022, 17, 18,
    2001, 2006, 2007, 2009, 2015, 2016, 2030, 2034, 2033, 2008, 2025, 2029,
    2031, 2022, 49, 50, 51, 52, 53, 54,
)

ROI_NAMES: Tuple[str, ...] = (
    "ctx-lh-bankssts", "ctx-lh-entorhinal", "ctx-lh-fusiform",
    "ctx-lh-inferiortemporal", "ctx-lh-middletemporal",
    "ctx-lh-parahippocampal", "ctx-lh-superiortemporal",
    "ctx-lh-transversetemporal", "ctx-lh-temporalpole",
    "ctx-lh-inferiorparietal", "ctx-lh-precuneus", "ctx-lh-superiorparietal",
    "ctx-lh-supramarginal", "ctx-lh-postcentral",
    "Left-Hippocampus", "Left-Amygdala",
    "ctx-rh-bankssts", "ctx-rh-entorhinal", "ctx-rh-fusiform",
    "ctx-rh-inferiortemporal", "ctx-rh-middletemporal",
    "ctx-rh-parahippocampal", "ctx-rh-superiortemporal",
    "ctx-rh-transversetemporal", "ctx-rh-temporalpole",
    "ctx-rh-inferiorparietal", "ctx-rh-precuneus", "ctx-rh-superiorparietal",
    "ctx-rh-supramarginal", "ctx-rh-postcentral",
    "Right-Thalamus-Proper", "Right-Caudate", "Right-Putamen",
    "Right-Pallidum", "Right-Hippocampus", "Right-Amygdala",
)

ROI_INDEX_TO_NAME = dict(zip(ROI_INDICES, ROI_NAMES))

# Template-space ROI labels (`-template_space`): Yeo-7 network labels 1..8.
TEMPLATE_ROI_INDICES: Tuple[int, ...] = tuple(range(1, 9))

DEFAULT_HOLDOUT_IDS: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ModelConfig:
    """ContraAttnUNET architecture. `pallas_convs`, `packed_level` and
    `remat` choose TPU kernel routes in the JAX package; the port keeps
    them so that a configuration reads the same, and ignores them."""

    spatial_dims: int = 3
    in_channels: int = 1
    out_channels: int = 1
    channels: Tuple[int, ...] = (32, 64, 128, 256, 512)
    strides: Tuple[int, ...] = (2, 2, 2, 2, 2)
    kernel_size: int = 3
    up_kernel_size: int = 3
    dropout: float = 0.0
    conditional: bool = True
    num_covars: int = 6          # [abeta, age, sex, edu, cog, meta_tau]
    block_num_covars: int = 5    # ConvBlocks see covars[..., :5]
    num_experts: int = 8
    film: bool = True
    latent_spaces: Tuple[int, ...] = (2048,) * 5
    with_modulator: bool = True
    prompt_shape: Tuple[int, int, int] = (128, 128, 128)
    norm: str = "instance"       # "instance" | "batch" | "none"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    pallas_convs: bool = True
    packed_level: bool = True
    remat: bool = True

    @property
    def depth(self) -> int:
        return len(self.channels)


@dataclass(frozen=True)
class LossConfig:
    """Composite loss assembly."""

    roi_weight: float = 225.0          # native space (template space: 1.0)
    gen_weight: float = 1.0
    reg_weight: float = 0.0            # lambda_2 (pred-space contrastive)
    ds_reg_weight: float = 1.0         # lambda_1 (tCDS / RnC slot)
    rnc: bool = True                   # RnCLoss in the tCDS slot
    rnc_temperature: float = 2.0
    voxel_wise: bool = False
    scale_factor: float = 360.0
    # tCDS per-level weights: 5 * normalize([0, 1, 4, 9, 16])
    cds_weights: Tuple[float, ...] = tuple(
        5.0 * w / sum((0.0, 1.0, 4.0, 9.0, 16.0))
        for w in (0.0, 1.0, 4.0, 9.0, 16.0)
    )
    triplet_margin: float = 1.0


@dataclass(frozen=True)
class TrainConfig:
    """Training loop hyperparameters."""

    epochs: int = 61
    lr: float = 1e-3
    batch_size: int = 2
    weight_decay: float = 0.01
    grad_acc: int = 1
    val_iter: int = 5
    overfit_val_iter: int = 10
    checkpoint_iter: int = 5
    plateau_patience: int = 5
    plateau_factor: float = 0.1
    seed: int = 0
    data_parallel: int = 1
    spatial_parallel: int = 1
    adaptive_roi_weights: bool = True


@dataclass(frozen=True)
class DataConfig:
    """Dataset and pipeline options."""

    splits_dir: str = ""
    covariate_csv: str = ""
    quartile_csv: str = ""
    fold: int = 4
    volume_shape: Tuple[int, int, int] = (128, 128, 128)
    template_space: bool = False       # -> pad to 216^3 unless resize
    resize: bool = True
    smoothing: bool = False
    contrastive: bool = True
    mode: str = "cluster"              # 'contrastive' | 'cluster'
    mri_file_type: Optional[str] = None
    tau_file_type: Optional[str] = None
    holdout_ids: Tuple[str, ...] = DEFAULT_HOLDOUT_IDS
    roi_template_path: str = ""
    prefetch: int = 2
    num_workers: int = 4
    shuffle: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    save_path: str = "results"
    description: str = ""
    model_type: str = "ContraAttnUNET"

    def normalized(self) -> "ExperimentConfig":
        """Reconcile the coupled geometry knobs:

        * template space pads volumes to 216^3 when `volume_shape` was left
          at the native-space default;
        * the modulator's prompts must match the input's spatial dims, so
          `model.prompt_shape` follows `data.volume_shape`.
        """
        data = self.data
        if data.template_space and tuple(data.volume_shape) == (128, 128, 128):
            data = dataclasses.replace(data, volume_shape=(216, 216, 216))
        model = self.model
        if tuple(model.prompt_shape) != tuple(data.volume_shape):
            model = dataclasses.replace(
                model, prompt_shape=tuple(data.volume_shape))
        if model is self.model and data is self.data:
            return self
        return dataclasses.replace(self, model=model, data=data)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        raw = json.loads(text)
        return cls(
            model=_from_dict(ModelConfig, raw.get("model", {})),
            loss=_from_dict(LossConfig, raw.get("loss", {})),
            train=_from_dict(TrainConfig, raw.get("train", {})),
            data=_from_dict(DataConfig, raw.get("data", {})),
            **{k: raw[k] for k in ("save_path", "description", "model_type")
               if k in raw},
        )


def _from_dict(cls: Any, raw: dict) -> Any:
    """`cls(**raw)` over the fields `cls` has, lists made tuples; unknown
    keys are ignored."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in raw.items() if k in names})


__all__ = ["DataConfig", "ExperimentConfig", "LossConfig", "ModelConfig",
           "ROI_INDEX_TO_NAME", "ROI_INDICES", "ROI_NAMES",
           "TEMPLATE_ROI_INDICES", "TrainConfig"]
