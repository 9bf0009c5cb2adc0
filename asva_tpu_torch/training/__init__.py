from .animation_trainer import (AnimationTrainConfig, AnimationTrainer,  # noqa: F401
                                TrainState)
from .optim import build_optimizer, trainable_mask  # noqa: F401
