from .optim import (
    OPTIMIZER_REGISTRY,
    RegimeSchedule,
    SignCompress,
    make_optimizer,
    regime_hp_kwargs,
    sign_compress,
)
from .trainer import (
    TrainConfig,
    Trainer,
    clamp_latent,
    load_checkpoint,
    make_eval_epoch_fn,
    make_eval_step,
    make_step_body,
    make_train_epoch_fn,
    make_train_scan,
)

__all__ = [
    "OPTIMIZER_REGISTRY",
    "RegimeSchedule",
    "SignCompress",
    "TrainConfig",
    "Trainer",
    "clamp_latent",
    "load_checkpoint",
    "make_eval_epoch_fn",
    "make_eval_step",
    "make_optimizer",
    "make_step_body",
    "make_train_epoch_fn",
    "make_train_scan",
    "regime_hp_kwargs",
    "sign_compress",
]
