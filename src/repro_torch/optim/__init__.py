from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, adamw_update_,
                                     adamw_update_plain_, cosine_schedule,
                                     global_norm)
