"""pdecontrolgym_jax — a batched PDE boundary-control environment engine.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of
lukebhan/PDEControlGym: six boundary-controlled PDE environments (1D transport,
reaction-diffusion, Burgers, ARZ traffic, glioblastoma, neuron growth; 2D
incompressible Navier-Stokes), a plug-in reward system, backstepping
controllers, on-device PPO/SAC, and a Gymnasium-compatible adapter — all built
on a pure-functional env protocol that jits, vmaps over thousands of envs, and
shards over device meshes.

Layers (see SURVEY.md §7):
    ops/       batched stencil / tridiagonal / Poisson kernels (XLA + Pallas)
    core/      functional env protocol, sensing/actuation dispatch
    envs/      the seven PDE environments
    rewards/   plug-in reward functions
    parallel/  vmap/shard_map rollout engine over device meshes
    compat/    Gymnasium adapter with the reference's exact kwargs API
    agents/    backstepping controllers, PPO, SAC
"""

from pdecontrolgym_jax.core.base import FunctionalEnv, RewardCtx, StepOut

__version__ = "0.1.0"

# Gymnasium adapter registration (same env IDs as the reference,
# pde_control_gym/__init__.py:1-18 — with its broken third register call fixed).
try:
    from pdecontrolgym_jax.compat.registration import register_all as _register_all

    _register_all()
except ImportError:  # gymnasium not installed; functional API still works
    pass

__all__ = ["FunctionalEnv", "RewardCtx", "StepOut", "__version__"]
