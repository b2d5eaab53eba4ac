"""Training: the step factory and the fault-tolerant Trainer."""
from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

__all__ = ["TrainConfig", "Trainer", "make_train_step"]
