from repro_torch.optim.optimizers import (OptState, Optimizer, adamw,
                                          apply_updates, momentum, sgd)
from repro_torch.optim.schedule import constant, cosine_decay, warmup_cosine

__all__ = ["OptState", "Optimizer", "adamw", "apply_updates", "constant",
           "cosine_decay", "momentum", "sgd", "warmup_cosine"]
