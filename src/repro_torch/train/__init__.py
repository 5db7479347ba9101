"""repro_torch.train — the training loop (port of `repro.train`)."""
from repro_torch.train.trainer import TrainConfig, train

__all__ = ["TrainConfig", "train"]
