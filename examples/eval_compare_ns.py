"""Compare controllers on the 2D Navier-Stokes tracking task: zero action vs
constant-lid (the target's own action sequence) vs PPO vs SAC.

Batched JAX counterpart of the reference's NS training pair
(``examples/NavierStokes/NS2Dppo.py:56-66``, ``NS2Dsac.py``): track the
lid-driven trajectory ``U_ref`` (their ``target.npz``; regenerated here by
``make_lid_target``) from random constant initial conditions u,v,p ~ U(-5,5)
(``NS2Dppo.py:14-18``) under ``NSReward(0.1)``. The reference trains SB3 for
2e5 steps and publishes no eval number — the quality bar here is the
separation between the learned policies, the zero policy, and the
constant-lid reference action.

Run: python examples/eval_compare_ns.py --ppo-iters 60 --sac-iters 150
"""

import argparse

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer
from pdecontrolgym_jax.envs import FlatObsEnv, NavierStokesConfig, NavierStokesEnv
from pdecontrolgym_jax.envs.navier_stokes import (
    freeze_boundary_condition,
    make_lid_target,
)
from pdecontrolgym_jax.eval import compare_controllers
from pdecontrolgym_jax.rewards.ns import NSReward

BC = freeze_boundary_condition({
    "upper": ["Controllable", "Dirchilet"],
    "lower": ["Dirchilet", "Dirchilet"],
    "left": ["Dirchilet", "Dirchilet"],
    "right": ["Dirchilet", "Dirchilet"],
})


def build_env():
    # the reference's exact task geometry (NS2Dppo.py:29-50): T=0.2, dt=1e-3,
    # 21x21 grid; fast direct spectral pressure solve (exact fixed point)
    cfg = NavierStokesConfig(
        T=0.2, dt=1e-3, X=1.0, dx=0.05, Y=1.0, dy=0.05,
        boundary_condition=BC, dtype=jnp.float32, pressure_solver="direct",
    )
    U_ref, action_ref = make_lid_target(cfg, lid=2.0)
    return FlatObsEnv(NavierStokesEnv(cfg, NSReward(0.1), U_ref, action_ref))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=50)
    ap.add_argument("--ppo-iters", type=int, default=60)
    ap.add_argument("--sac-iters", type=int, default=150)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--save-params", default=None,
                    help="directory for ns_ppo.msgpack / ns_sac.msgpack")
    args = ap.parse_args()

    env = build_env()
    results = {}

    controllers = {
        "zero": lambda o, k: jnp.zeros((o.shape[0], 1)),
        "constant-lid": lambda o, k: jnp.full((o.shape[0], 1), 2.0),
    }
    results.update(compare_controllers(env, controllers,
                                       num_episodes=args.episodes,
                                       max_steps=200))

    def eval_fn_for(policy_of_params):
        def eval_fn(params):
            r = compare_controllers(
                env, {"c": policy_of_params(params)},
                num_episodes=16, max_steps=200, key=jax.random.key(7),
            )
            return r["c"]["mean_return"]

        return eval_fn

    if args.ppo_iters > 0:
        trainer = PPOTrainer(env, PPOConfig(
            num_envs=128, num_steps=200, gamma=0.99, num_minibatches=16,
            num_epochs=4, ent_coef=1e-3, reward_scale=0.05, obs_clip=20.0,
        ))
        runner = trainer.train(
            jax.random.key(0), args.ppo_iters,
            eval_fn=eval_fn_for(trainer.policy), eval_every=args.eval_every,
            callback=lambda it, m: print(
                f"  ppo iter {it}: mean {m['mean_reward']:+.3f}"
                + (f"  eval {m['eval']:+.2f} (best {m['best_eval']:+.2f})"
                   if "eval" in m else ""), flush=True),
        )
        results.update(compare_controllers(
            env, {"ppo": trainer.policy(runner.params)},
            num_episodes=args.episodes, max_steps=200))
        if args.save_params:
            from pdecontrolgym_jax.utils import save_params

            save_params(f"{args.save_params}/ns_ppo.msgpack", runner.params)

    if args.sac_iters > 0:
        # lr=1e-3 + updates_per_iter=32 swept best (round 2): -5.59 final vs
        # -7.48 with the lr=3e-4/16-update recipe (constant-lid oracle: -5.16)
        trainer = SACTrainer(env, SACConfig(
            num_envs=64, buffer_size=200_000, batch_size=256,
            steps_per_iter=8, updates_per_iter=32, gamma=0.99, lr=1e-3,
            init_alpha=0.1, reward_scale=0.05,
            action_low=-4.0, action_high=4.0,  # lid range covering 2.0
        ))
        runner = trainer.train(
            jax.random.key(1), args.sac_iters,
            eval_fn=eval_fn_for(trainer.policy), eval_every=args.eval_every,
            callback=lambda it, m: print(
                f"  sac iter {it}: mean {m['mean_reward']:+.3f}"
                + (f"  eval {m['eval']:+.2f} (best {m['best_eval']:+.2f})"
                   if "eval" in m else ""), flush=True),
        )
        results.update(compare_controllers(
            env, {"sac": trainer.policy(runner.actor_params)},
            num_episodes=args.episodes, max_steps=200))
        if args.save_params:
            from pdecontrolgym_jax.utils import save_params

            save_params(f"{args.save_params}/ns_sac.msgpack", runner.actor_params)

    print(f"\n{'controller':>14} | {'mean return':>12} | {'std':>8}")
    for name, r in sorted(results.items(), key=lambda kv: -kv[1]["mean_return"]):
        print(f"{name:>14} | {r['mean_return']:12.2f} | {r['std_return']:8.2f}")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
