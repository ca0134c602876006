from pdecontrolgym_jax.core.base import (
    FunctionalEnv,
    RewardCtx,
    StepOut,
    roll_ring,
)
from pdecontrolgym_jax.core.sensing import make_control_fn, make_sensing_fn

__all__ = [
    "FunctionalEnv",
    "RewardCtx",
    "StepOut",
    "roll_ring",
    "make_control_fn",
    "make_sensing_fn",
]
