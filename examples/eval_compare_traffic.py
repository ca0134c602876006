"""Compare ARZ traffic outlet controllers: backstepping law vs PPO.

Batched JAX counterpart of the reference traffic tutorial's RL section
(``docs/source/tutorials/Trafficarz1d_tutorial.rst:256-309``): train PPO in
the ``outlet-train`` mode (stochastic steady-state resampling + normalized
deviation observations, ``traffic_arz_env.py:67,231``), then evaluate in the
deterministic ``outlet`` mode against the tutorial's backstepping outlet law
(:146-186). The reference publishes trajectory plots only; the quantitative
comparison here is the cumulative tracking reward over the T=240s episode
(early-stop at reward > -0.00023 like the reference's eval loop) and the
convergence step.

Run: python examples/eval_compare_traffic.py --ppo-iters 300
"""

import argparse

import numpy as np

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.envs import TanhBoxActionEnv, TransformObsEnv
from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv, veq
from pdecontrolgym_jax.rewards import TrafficARZReward


def backstepping_controller(cfg, env):
    """The tutorial's outlet backstepping law (Trafficarz1d_tutorial.rst:146-186)."""
    M = cfg.M
    vs, rs = cfg.v_steady, cfg.ro_steady
    vm, rm, tau = cfg.v_max, cfg.ro_max, cfg.tau
    qs, ps = rs * vs, env.ps
    x = jnp.arange(0, cfg.X + cfg.dx, cfg.dx, dtype=jnp.float32)
    lam2 = vs + rs * (-vm / rm)
    K = -(1 / ps) * (-1 / tau) * jnp.exp(-x / (tau * vs))
    cv = -K + (lam2 / vs) * K * jnp.exp(x / (vs * tau))
    cq = ((vs - lam2) / vs) * K * jnp.exp(x / (vs * tau))

    def controller(obs):
        r, v = obs[:M], obs[M:]
        iv = jnp.trapezoid(cv * (v - vs), dx=cfg.dx)
        iq = jnp.trapezoid(cq * (r * v - qs), dx=cfg.dx)
        return qs + rs * iv + iq

    return controller


def episode_metrics(env, policy, max_steps=960):
    """One deterministic outlet episode (the PDE horizon is T/dt = 960 steps;
    beyond it the reference freezes the state, ``traffic_arz_env.py:173``).
    Returns (total reward, final-step reward, steps run, final obs); the
    episode ends earlier only on the reference's near-exact-convergence
    early stop (reward > -0.00023)."""

    @jax.jit
    def run():
        state, obs = env.init(None)

        def body(carry, _):
            state, obs, alive, total, last, steps = carry
            state, out = env.step(state, policy(obs))
            total = total + jnp.where(alive, out.reward, 0.0)
            last = jnp.where(alive, out.reward, last)
            steps = steps + alive.astype(jnp.int32)
            done = jnp.logical_or(out.terminated, out.truncated)
            alive = jnp.logical_and(alive, ~done)
            return (state, out.obs, alive, total, last, steps), None

        carry = (state, obs, jnp.asarray(True), jnp.zeros(()), jnp.zeros(()),
                 jnp.zeros((), jnp.int32))
        (state, obs, alive, total, last, steps), _ = jax.lax.scan(
            body, carry, None, length=max_steps
        )
        return total, last, steps, obs

    total, last, steps, obs = run()
    return float(total), float(last), int(steps), np.asarray(obs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ppo-iters", type=int, default=300)
    ap.add_argument("--sac-iters", type=int, default=0,
                    help=">0: also train/evaluate SAC (same outlet-train task)")
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--save-params", default=None,
                    help="directory for traffic_{ppo,sac}.msgpack")
    args = ap.parse_args()

    cfg_eval = TrafficARZConfig(simulation_type="outlet")
    env_eval = TrafficARZEnv(cfg_eval, TrafficARZReward())
    M = cfg_eval.M
    rs, vs = cfg_eval.ro_steady, cfg_eval.v_steady

    rows = {}
    bck = backstepping_controller(cfg_eval, env_eval)
    rows["backstepping"] = episode_metrics(env_eval, lambda o: bck(o)[None])

    if args.ppo_iters > 0:
        # train on outlet-train (normalized deviations, resampled steady
        # states); tanh-box action map centers the policy on the flux box
        cfg_tr = TrafficARZConfig(simulation_type="outlet-train")
        env_tr = TanhBoxActionEnv(TrafficARZEnv(cfg_tr, TrafficARZReward()))
        trainer = PPOTrainer(env_tr, PPOConfig(
            num_envs=256, num_steps=64, gamma=0.995, num_minibatches=8,
            num_epochs=4, ent_coef=1e-3, reward_scale=5.0,
        ))

        # eval adapter: outlet mode + the tutorial RLController normalization
        def norm_obs(obs):
            r, v = obs[:M], obs[M:]
            return jnp.concatenate([(r - rs) / rs, (v - vs) / vs])

        env_pol = TransformObsEnv(TanhBoxActionEnv(env_eval), norm_obs)

        def eval_fn(params):
            pol = trainer.policy(params)
            total, _, _, _ = episode_metrics(env_pol, lambda o: pol(o[None])[0])
            return total

        runner = trainer.train(
            jax.random.key(0), args.ppo_iters, eval_fn=eval_fn,
            eval_every=args.eval_every,
            callback=lambda it, m: print(
                f"  ppo iter {it}: mean {m['mean_reward']:+.5f}"
                + (f"  eval {m['eval']:+.4f} (best {m['best_eval']:+.4f})"
                   if "eval" in m else ""), flush=True),
        )
        pol = trainer.policy(runner.params)
        rows["ppo"] = episode_metrics(env_pol, lambda o: pol(o[None])[0])
        if args.save_params:
            from pdecontrolgym_jax.utils import save_params

            save_params(f"{args.save_params}/traffic_ppo.msgpack", runner.params)

    if args.sac_iters > 0:
        from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer

        # SAC trains on the RAW outlet-train env: its tanh actor scales
        # straight onto the flux box (no TanhBoxActionEnv double-squash)
        cfg_tr = TrafficARZConfig(simulation_type="outlet-train")
        env_tr = TrafficARZEnv(cfg_tr, TrafficARZReward())

        def norm_obs(obs):
            r, v = obs[:M], obs[M:]
            return jnp.concatenate([(r - rs) / rs, (v - vs) / vs])

        env_sac_eval = TransformObsEnv(env_eval, norm_obs)
        sac = SACTrainer(env_tr, SACConfig(
            num_envs=64, buffer_size=200_000, batch_size=256,
            steps_per_iter=8, updates_per_iter=16, gamma=0.995, lr=1e-3,
            init_alpha=0.1, reward_scale=5.0,
            action_low=float(env_tr.action_low),
            action_high=float(env_tr.action_high),
        ))

        def eval_sac(params):
            pol = sac.policy(params)
            total, _, _, _ = episode_metrics(
                env_sac_eval, lambda o: pol(o[None])[0]
            )
            return total

        runner = sac.train(
            jax.random.key(1), args.sac_iters, eval_fn=eval_sac,
            eval_every=args.eval_every,
            callback=lambda it, m: print(
                f"  sac iter {it}: mean {m['mean_reward']:+.5f}"
                + (f"  eval {m['eval']:+.4f} (best {m['best_eval']:+.4f})"
                   if "eval" in m else ""), flush=True),
        )
        pol = sac.policy(runner.actor_params)
        rows["sac"] = episode_metrics(env_sac_eval, lambda o: pol(o[None])[0])
        if args.save_params:
            from pdecontrolgym_jax.utils import save_params

            save_params(f"{args.save_params}/traffic_sac.msgpack",
                        runner.actor_params)

    print(f"\n{'controller':>14} | {'total reward':>12} | {'final reward':>12} | {'steps':>6}")
    for name, (total, last, steps, obs) in rows.items():
        print(f"{name:>14} | {total:12.4f} | {last:12.5f} | {steps:6d}")
    print("(T=240s horizon = 960 PDE steps; early stop only on near-exact "
          f"convergence, reward > {cfg_eval.early_stop_threshold})")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
