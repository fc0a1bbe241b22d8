from .adamw import (OptimizerConfig, adamw_init, adamw_update,
                    global_norm, clip_by_global_norm)
from .schedule import cosine_schedule

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule"]
