"""Train SAC on any of the 1D boundary-control envs or 2D Navier-Stokes.

Covers the reference's SAC trainer scripts with one entry point
(``transport1Dsac.py``, ``reactionDiffusion1Dsac.py``, ``NS2Dsac.py``):

    python examples/train_sac_any.py --env reaction_diffusion --iterations 300
    python examples/train_sac_any.py --env ns --iterations 150
"""

import argparse

import jax

from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
from pdecontrolgym_jax.utils import save
from train_ppo_any import build  # same env zoo


CONFIGS = {
    "transport": SACConfig(num_envs=64, buffer_size=400_000, batch_size=512,
                           steps_per_iter=2, updates_per_iter=32, gamma=0.999,
                           init_alpha=0.05),
    "reaction_diffusion": SACConfig(num_envs=64, buffer_size=400_000,
                                    batch_size=512, steps_per_iter=8,
                                    updates_per_iter=32, gamma=0.9995,
                                    init_alpha=0.05, reward_scale=0.1),
    "burgers": SACConfig(num_envs=64, buffer_size=200_000, batch_size=256,
                         steps_per_iter=4, updates_per_iter=16, gamma=0.995),
    "ns": SACConfig(num_envs=64, buffer_size=200_000, batch_size=256,
                    steps_per_iter=8, updates_per_iter=16, gamma=0.99,
                    reward_scale=0.05, action_low=-4.0, action_high=4.0),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="reaction_diffusion", choices=sorted(CONFIGS))
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--checkpoint", default=None)
    args = ap.parse_args()

    env = build(args.env)
    trainer = SACTrainer(env, CONFIGS[args.env])
    runner = trainer.train(
        jax.random.key(0), args.iterations,
        callback=lambda it, m: print(
            f"[{args.env}] iter {it:4d}  mean_reward {m['mean_reward']:+.4f}  "
            f"alpha {m['alpha']:.3f}", flush=True),
    )
    if args.checkpoint:
        save(args.checkpoint, runner)


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
