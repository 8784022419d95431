"""Checkpoints on `torch.save` / `torch.load` (counterpart of
`coma_unet_tpu/train/checkpoint.py`), with the reference's cadence and
names: every epoch `<save_path>/checkpoints/checkpoint_latest_epoch`, every
`checkpoint_iter` epochs `checkpoint_epoch_{E}`. The payload is the epoch,
the last loss, the model's and the optimizer's state dicts, the step count
(flax's: every `apply_gradients` call) and the plateau controller's state;
the training loop adds the adapted ROI (voxel) weights.

A checkpoint is written to a temporary name and moved into place with
`os.replace`, so a crash leaves the last whole one. It holds only tensors,
containers and Python scalars, and is read back with
`torch.load(weights_only=True)`.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from coma_unet_tpu_torch.train.optim import ReduceLROnPlateau
from coma_unet_tpu_torch.train.state import TrainState


def _plain(value: Any) -> Any:
    """numpy scalars -> Python scalars, through containers."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if hasattr(value, "item") and not isinstance(value, torch.Tensor):
        return value.item()
    return value


class CheckpointManager:
    def __init__(self, save_path: str):
        self.root = os.path.abspath(os.path.join(save_path, "checkpoints"))
        os.makedirs(self.root, exist_ok=True)

    def _payload(self, state: TrainState, epoch: int, loss: float,
                 scheduler: Optional[ReduceLROnPlateau],
                 extra: Dict[str, Any]) -> Dict[str, Any]:
        return _plain({
            "epoch": int(epoch),
            "loss": float(loss),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "scheduler": (scheduler or ReduceLROnPlateau()).state_dict(),
            **extra,
        })

    def save(self, state: TrainState, epoch: int, loss: float,
             scheduler: Optional[ReduceLROnPlateau] = None,
             tag: Optional[str] = None, **extra) -> str:
        """Write `checkpoint_{tag}` (default `checkpoint_epoch_{epoch}`);
        `extra` entries join the payload."""
        name = tag if tag is not None else f"epoch_{epoch}"
        path = os.path.join(self.root, f"checkpoint_{name}")
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(self._payload(state, epoch, loss, scheduler, extra), tmp)
        os.replace(tmp, path)
        return path

    def save_epoch(self, state: TrainState, epoch: int, loss: float,
                   scheduler: Optional[ReduceLROnPlateau] = None,
                   checkpoint_iter: int = 5, **extra) -> None:
        """`latest_epoch` every epoch, `epoch_{E}` every `checkpoint_iter`."""
        self.save(state, epoch, loss, scheduler, tag="latest_epoch", **extra)
        if epoch % checkpoint_iter == 0:
            self.save(state, epoch, loss, scheduler, **extra)

    def restore(self, state: TrainState, path: Optional[str] = None,
                scheduler: Optional[ReduceLROnPlateau] = None
                ) -> Tuple[TrainState, int, float]:
        """Load a checkpoint (default: the latest) into `state`'s model and
        optimizer, on the model's device, and into `scheduler` when given.
        Returns (state, epoch, loss)."""
        payload = self.restore_payload(state, path, scheduler)
        return state, int(payload["epoch"]), float(payload["loss"])

    def restore_payload(self, state: TrainState, path: Optional[str] = None,
                        scheduler: Optional[ReduceLROnPlateau] = None
                        ) -> Dict[str, Any]:
        """`restore`, returning the whole payload."""
        if path is None:
            path = os.path.join(self.root, "checkpoint_latest_epoch")
        return restore_payload(state, path, scheduler)


def restore_payload(state: TrainState, path: str,
                    scheduler: Optional[ReduceLROnPlateau] = None
                    ) -> Dict[str, Any]:
    """Load the checkpoint at `path` into `state`'s model and optimizer, and
    into `scheduler` when given; returns the whole payload. No directory is
    made (a data-parallel rank that writes nothing restores with this)."""
    payload = load_checkpoint(path)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None and payload.get("scheduler"):
        scheduler.load_state_dict(payload["scheduler"])
    return payload


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's payload, its tensors on the CPU; `load_state_dict`
    then copies them onto the model's device (the optimizer keeps its step
    counts on the CPU, as torch's AdamW does)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def parse_epoch_from_path(path: str) -> Optional[int]:
    """`checkpoint_epoch_{E}` -> E."""
    base = os.path.basename(path.rstrip("/"))
    if base.startswith("checkpoint_epoch_"):
        try:
            return int(base.split("_")[-1])
        except ValueError:
            return None
    return None
