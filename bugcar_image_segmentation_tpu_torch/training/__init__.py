"""Training: the loss, the train state, the train and eval steps, AdamW
as optax computes it, and batch augmentation.

Port of ``bugcar_image_segmentation_tpu/training/``; the parallel steps
take a ``parallel.Mesh``.
"""

from .optim import (SGD, AdamW, AdamWState, warmup_constant,
                    warmup_cosine_decay)
from .trainer import (TrainState, create_train_state, make_eval_step,
                      make_train_step, softmax_cross_entropy)

__all__ = ["AdamW", "AdamWState", "SGD", "TrainState", "create_train_state",
           "make_eval_step", "make_train_step", "softmax_cross_entropy",
           "warmup_constant", "warmup_cosine_decay"]
