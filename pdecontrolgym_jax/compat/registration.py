"""Gymnasium registration under the reference's env IDs.

The reference registers four IDs (``pde_control_gym/__init__.py:1-18``) but its
third ``register`` call is a SyntaxError (two ``id=`` kwargs in one call) that
was meant to register BrainTumor1D and TrafficPDE1D separately — fixed here:
all five IDs register cleanly, plus the Burgers env (not in the reference).
"""

from __future__ import annotations

from gymnasium.envs.registration import register, registry

_SPECS = {
    "PDEControlGym-TransportPDE1D": "pdecontrolgym_jax.compat.adapter:TransportPDE1D",
    "PDEControlGym-ReactionDiffusionPDE1D": "pdecontrolgym_jax.compat.adapter:ReactionDiffusionPDE1D",
    "PDEControlGym-BrainTumor1D": "pdecontrolgym_jax.compat.adapter:BrainTumor1D",
    "PDEControlGym-TrafficPDE1D": "pdecontrolgym_jax.compat.adapter:TrafficPDE1D",
    "PDEControlGym-NavierStokes2D": "pdecontrolgym_jax.compat.adapter:NavierStokes2D",
    "PDEControlGym-Burgers1D": "pdecontrolgym_jax.compat.adapter:BurgersPDE1D",
    # unregistered + unrunnable in the reference; fixed and registered here
    "PDEControlGym-NeuronPDE1D": "pdecontrolgym_jax.compat.adapter:NeuronPDE1D",
}


def register_all() -> None:
    for env_id, entry_point in _SPECS.items():
        if env_id not in registry:
            register(id=env_id, entry_point=entry_point, disable_env_checker=True)
