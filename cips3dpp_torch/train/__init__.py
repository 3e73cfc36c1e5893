"""Training of the generator: losses, state and optimizers, steps and the
training loop (counterpart of cips3dpp_tpu/train)."""

from .losses import (
    d_logistic_loss,
    eikonal_loss,
    g_nonsaturating_loss,
    minimal_surface_loss,
    path_length_penalty,
    path_noise,
    r1_penalty,
    viewpoint_loss,
)
from .state import TrainConfig, TrainState, create_train_state
from .steps import Draws, draw_inputs, ema_update, fade_alpha, make_train_steps
from .train_loop import TrainHooks, Trainer

__all__ = [
    "Draws", "TrainConfig", "TrainHooks", "TrainState", "Trainer", "create_train_state",
    "d_logistic_loss", "draw_inputs", "eikonal_loss", "ema_update", "fade_alpha",
    "g_nonsaturating_loss", "make_train_steps", "minimal_surface_loss",
    "path_length_penalty", "path_noise", "r1_penalty", "viewpoint_loss",
]
