"""Train PPO on any of the 1D boundary-control envs or 2D Navier-Stokes.

Covers the remaining reference trainer scripts with one entry point
(``reactionDiffusion1Dppo.py``, ``NS2Dppo.py``, plus Burgers):

    python examples/train_ppo_any.py --env reaction_diffusion --iterations 500
    python examples/train_ppo_any.py --env ns --iterations 200
"""

import argparse

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.rewards import TunedReward1D
from pdecontrolgym_jax.utils import save


from pdecontrolgym_jax.envs import FlatObsEnv


def build(name):
    if name == "transport":
        from pdecontrolgym_jax.envs import Boundary1DConfig, TransportEnv

        cfg = Boundary1DConfig(T=5.0, dt=1e-4, X=1.0, dx=1e-2,
                               control_sample_rate=0.1, normalize=True,
                               limit_pde_state_size=True)
        return TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2))
    if name == "reaction_diffusion":
        from pdecontrolgym_jax.envs import ReactionDiffusionConfig, ReactionDiffusionEnv

        cfg = ReactionDiffusionConfig(T=1.0, dt=1e-5, X=1.0, dx=5e-3,
                                      control_sample_rate=1e-3, normalize=True,
                                      limit_pde_state_size=True)
        return ReactionDiffusionEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2))
    if name == "burgers":
        from pdecontrolgym_jax.envs import BurgersConfig, BurgersEnv

        # CFL needs |u|·dt/dx <= 1: cap the control map at ±5 and truncate
        # blow-ups (divergence masking) so exploration can't poison the batch
        cfg = BurgersConfig(T=1.0, dt=1e-4, X=1.0, dx=1.0 / 256,
                            control_sample_rate=0.01, normalize=True,
                            max_control_value=5.0, limit_pde_state_size=True,
                            max_state_value=1e4, truncate_on_nonfinite=True)
        return BurgersEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))
    if name == "ns":
        from pdecontrolgym_jax.envs import (
            NavierStokesConfig, NavierStokesEnv, freeze_boundary_condition,
        )
        from pdecontrolgym_jax.envs.navier_stokes import make_lid_target
        from pdecontrolgym_jax.rewards.ns import NSReward

        bc = freeze_boundary_condition({
            "upper": ["Controllable", "Dirchilet"],
            "lower": ["Dirchilet", "Dirchilet"],
            "left": ["Dirchilet", "Dirchilet"],
            "right": ["Dirchilet", "Dirchilet"],
        })
        cfg = NavierStokesConfig(T=0.2, dt=1e-3, boundary_condition=bc,
                                 maximum_pressure_iteration=200,
                                 dtype=jnp.float32, pressure_layout="flat")
        U_ref, action_ref = make_lid_target(cfg, lid=2.0)
        return FlatObsEnv(NavierStokesEnv(cfg, NSReward(0.1), U_ref, action_ref))
    raise SystemExit(f"unknown env {name}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="reaction_diffusion",
                    choices=["transport", "reaction_diffusion", "burgers", "ns"])
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args()

    env = build(args.env)
    trainer = PPOTrainer(
        env,
        PPOConfig(num_envs=args.num_envs, num_steps=32, gamma=0.999,
                  num_minibatches=8, ent_coef=1e-3, reward_scale=0.02,
                  obs_clip=50.0),
    )
    runner = trainer.init(jax.random.key(0))
    step = trainer.make_train_step()
    for it in range(args.iterations):
        runner, m = step(runner)
        if it % 20 == 0 or it == args.iterations - 1:
            m = jax.device_get(m)
            print(f"[{args.env}] iter {it:4d}  mean_reward {m['mean_reward']:+.4f}",
                  flush=True)
    if args.checkpoint:
        save(args.checkpoint, runner)


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
