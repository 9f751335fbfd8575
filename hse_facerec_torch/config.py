"""Training hyperparameters.

The port's own copy of ``hse_facerec_tf_tpu/config.py::TrainConfig``, with
the same fields and defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters (reference ``facerec_keras_train.py:149-215``,
    ``age_gender_train.py:116-123,240-269``)."""
    batch_size: int = 32
    learning_rate: float = 1e-3
    lr_decay: float = 1e-5
    weight_decay: float = 4e-5
    epochs: int = 16
    early_stopping_patience: int = 2
    image_size: int = 224
    finetune_learning_rate: float = 1e-4
    frozen_epochs: int = 3
    finetune_epochs: int = 30
