from pdecontrolgym_jax.rewards.base import BaseReward
from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward
from pdecontrolgym_jax.rewards.norm import NormReward
from pdecontrolgym_jax.rewards.ns import NSReward
from pdecontrolgym_jax.rewards.traffic import TrafficARZReward
from pdecontrolgym_jax.rewards.tuned import TunedReward1D

__all__ = [
    "BaseReward",
    "BrainTumorReward",
    "NSReward",
    "NormReward",
    "TrafficARZReward",
    "TunedReward1D",
]
