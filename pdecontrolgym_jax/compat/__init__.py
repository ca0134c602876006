from pdecontrolgym_jax.compat.adapter import (
    Boundary1DGymEnv,
    BrainTumor1D,
    BurgersPDE1D,
    NavierStokes2D,
    NeuronPDE1D,
    ReactionDiffusionPDE1D,
    TherapyWrapper,
    TrafficPDE1D,
    TransportPDE1D,
)
from pdecontrolgym_jax.compat.vector import PDEVectorEnv

__all__ = [
    "Boundary1DGymEnv",
    "BrainTumor1D",
    "BurgersPDE1D",
    "NavierStokes2D",
    "NeuronPDE1D",
    "PDEVectorEnv",
    "ReactionDiffusionPDE1D",
    "TherapyWrapper",
    "TrafficPDE1D",
    "TransportPDE1D",
]
