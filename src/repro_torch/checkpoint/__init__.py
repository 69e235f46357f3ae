from repro_torch.checkpoint.checkpoint import (latest_checkpoint,
                                               restore_pytree, save_pytree)

__all__ = ["latest_checkpoint", "restore_pytree", "save_pytree"]
