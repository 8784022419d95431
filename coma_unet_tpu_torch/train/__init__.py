"""Training of the port (counterpart of `coma_unet_tpu/train/`): the train
and eval steps, AdamW (with gradient accumulation) and the plateau
controller, the train state, checkpoints, the metric recorder and the
training loop."""

from coma_unet_tpu_torch.train.optim import (  # noqa: F401
    MultiSteps,
    ReduceLROnPlateau,
    get_lr,
    make_optimizer,
    set_lr,
)
from coma_unet_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    param_count,
)
from coma_unet_tpu_torch.train.step import (  # noqa: F401
    global_norm,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)
