"""Training stack of the port: the train step and loop, checkpoints,
configs."""

from .train_lib import (CheckpointManager, TrainState, TrainingOptions,
                        create_optimizer, create_train_state,
                        learning_rate_schedule, make_train_step, train,
                        train_loop)

__all__ = [
    'CheckpointManager', 'TrainState', 'TrainingOptions', 'create_optimizer',
    'create_train_state', 'learning_rate_schedule', 'make_train_step',
    'train', 'train_loop',
]
