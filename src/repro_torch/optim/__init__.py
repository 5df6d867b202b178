"""Optimizers and schedules (twins of ``repro.optim``)."""
from .optimizers import (AdamW, SGDMomentum, clip_by_global_norm,
                         cosine_schedule, global_norm)

__all__ = ["AdamW", "SGDMomentum", "cosine_schedule", "clip_by_global_norm",
           "global_norm"]
