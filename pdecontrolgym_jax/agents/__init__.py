from pdecontrolgym_jax.agents.backstepping import (
    parabolic_control,
    parabolic_kernel,
    transport_control,
    transport_kernel,
)
from pdecontrolgym_jax.agents.networks import ActorCritic
from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer

__all__ = [
    "ActorCritic",
    "PPOConfig",
    "PPOTrainer",
    "SACConfig",
    "SACTrainer",
    "parabolic_control",
    "parabolic_kernel",
    "transport_control",
    "transport_kernel",
]
