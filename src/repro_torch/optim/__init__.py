"""AdamW (counterpart of ``repro.optim``)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state, lr_schedule

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_schedule"]
