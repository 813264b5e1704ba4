"""Training substrate: optimizer, data pipeline, checkpointing, train loop."""

from repro_torch.training.optimizer import adamw_init, adamw_update, lr_schedule  # noqa: F401
from repro_torch.training.data import SyntheticTokenStream  # noqa: F401
from repro_torch.training.train_loop import TrainState, make_train_step, train  # noqa: F401
