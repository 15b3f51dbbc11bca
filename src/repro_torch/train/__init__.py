"""Training substrate: AdamW, loss, trainer, checkpointing (the port of
``repro.train``)."""
from .checkpoint import checkpoint_step, restore_checkpoint, save_checkpoint
from .loss import next_token_loss
from .optimizer import (AdamWConfig, OptState, adamw_update, global_norm,
                        init_opt_state, lr_schedule)
from .trainer import TrainState, init_train_state, make_train_step

__all__ = ["AdamWConfig", "OptState", "adamw_update", "init_opt_state",
           "lr_schedule", "global_norm", "next_token_loss", "TrainState",
           "make_train_step", "init_train_state", "save_checkpoint",
           "restore_checkpoint", "checkpoint_step"]
