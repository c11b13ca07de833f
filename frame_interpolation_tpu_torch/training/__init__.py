"""Training stack of the port: the train step and loop, checkpoints,
configs, and the eval loop and its metrics."""

from .eval_lib import eval_loop
from .metrics_lib import create_metrics_fns
from .train_lib import (CheckpointManager, TrainState, TrainingOptions,
                        create_optimizer, create_train_state,
                        learning_rate_schedule, make_train_step, train,
                        train_loop)

__all__ = [
    'CheckpointManager', 'TrainState', 'TrainingOptions', 'create_metrics_fns',
    'create_optimizer', 'create_train_state', 'eval_loop',
    'learning_rate_schedule', 'make_train_step', 'train', 'train_loop',
]
