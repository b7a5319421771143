from bert4clickpath.training.train_state import TrainState  # noqa: F401
from bert4clickpath.training.trainer import Trainer  # noqa: F401
