"""Training arguments: the optimizer subset of `rgbdseg_tpu/train/arguments.py`
(`TrainingArguments`, same names and defaults). The rest of the JAX package's
arguments (data, checkpoints, evaluation, logging) belongs to the finetune CLI,
which is not ported yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TrainingArguments:
    num_train_epochs: float = 1.0
    per_device_train_batch_size: int = 1
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0  # HF Trainer default clip
    warmup_ratio: float = 0.0
