"""Training of the port (counterpart of `coma_unet_tpu/train/`): the train
step, AdamW and the plateau controller, and the train state."""

from coma_unet_tpu_torch.train.optim import (  # noqa: F401
    ReduceLROnPlateau,
    get_lr,
    make_optimizer,
    set_lr,
)
from coma_unet_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
)
from coma_unet_tpu_torch.train.step import (  # noqa: F401
    global_norm,
    make_loss_fn,
    make_train_step,
)
