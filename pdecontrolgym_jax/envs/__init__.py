from pdecontrolgym_jax.envs.brain_tumor import (
    BrainTumorConfig,
    BrainTumorEnv,
    DoseTherapyEnv,
    TherapyEnv,
)
from pdecontrolgym_jax.envs.burgers import BurgersConfig, BurgersEnv
from pdecontrolgym_jax.envs.common import Boundary1DConfig, Boundary1DEnv, Boundary1DState
from pdecontrolgym_jax.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
)
from pdecontrolgym_jax.envs.neuron import NeuronConfig, NeuronEnv
from pdecontrolgym_jax.envs.reaction_diffusion import (
    ReactionDiffusionConfig,
    ReactionDiffusionEnv,
)
from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_jax.envs.transport import TransportConfig, TransportEnv, chebyshev_beta
from pdecontrolgym_jax.envs.wrappers import (
    FlatObsEnv,
    TanhBoxActionEnv,
    TransformObsEnv,
)

__all__ = [
    "FlatObsEnv",
    "TanhBoxActionEnv",
    "TransformObsEnv",
    "BrainTumorConfig",
    "BrainTumorEnv",
    "NeuronConfig",
    "NeuronEnv",
    "DoseTherapyEnv",
    "TherapyEnv",
    "Boundary1DConfig",
    "Boundary1DEnv",
    "Boundary1DState",
    "BurgersConfig",
    "BurgersEnv",
    "NavierStokesConfig",
    "NavierStokesEnv",
    "ReactionDiffusionConfig",
    "ReactionDiffusionEnv",
    "TrafficARZConfig",
    "TrafficARZEnv",
    "TransportConfig",
    "TransportEnv",
    "chebyshev_beta",
    "freeze_boundary_condition",
]
