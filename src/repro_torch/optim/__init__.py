"""Optimizers (ported subset: the paper's RMSProp)."""
from repro_torch.optim.optimizers import Optimizer, constant_schedule, rmsprop

__all__ = ["Optimizer", "constant_schedule", "rmsprop"]
