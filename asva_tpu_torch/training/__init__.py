from .animation_trainer import (AnimationTrainConfig, AnimationTrainer,  # noqa: F401
                                TrainState)
from .optim import build_optimizer, trainable_mask  # noqa: F401
from .sync_trainer import SyncContrastiveTrainer, SyncTrainState  # noqa: F401
