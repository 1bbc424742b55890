from repro_torch.optim.adamw import (
    OptConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    global_norm,
)

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm"]
