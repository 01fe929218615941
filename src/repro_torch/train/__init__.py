from repro_torch.train.loop import Trainer, TrainConfig  # noqa: F401
