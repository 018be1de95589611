"""LoRA training of MMDuet on one device (`python -m mmduet_tpu_torch.train.loop`)."""
from .optimizer import make_optimizer, make_lr_schedule, trainable_params
from .step import TrainState, make_train_step, init_train_state
