"""Training throughput: PPO or SAC train_step with the learner IN the loop.

Rollout-only numbers (bench.py) bound the env engine; this is the number a
user of the full stack gets. PPO (default): each iteration is one jitted
program containing the policy rollout (num_steps agent actions x 4096 envs,
each action zero-order-held for `sample_rate` PDE sub-steps), GAE, and
epochs x minibatches clipped-surrogate updates. ``--algo sac``: each
iteration collects steps_per_iter env steps into the device-resident
circular replay ring and runs updates_per_iter twin-critic/actor/alpha
updates on sampled batches — the off-policy profile (replay writes +
uniform sampling gathers) the PPO row doesn't exercise. Timing scans
``--inner`` train iterations inside ONE dispatch (fresh data each — the
runner carry advances), with ``block_until_ready``.

Prints ONE JSON line:
    {"metric": "<algo> train env-steps/s", "agent_steps_per_s": ...,
     "pde_substeps_per_s": ..., ...}
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp


def build(env_name="transport", algo="ppo", envs=4096, num_steps=16,
          nx=128):
    """``(trainer, step_fn, metric_key, pde_substeps_per_agent_step)`` for
    one training cell; ``step_fn(runner) -> (runner, metrics)``."""
    if env_name == "ns":
        from pdecontrolgym_jax.envs.navier_stokes import (
            NavierStokesConfig, NavierStokesEnv, freeze_boundary_condition,
            make_lid_target)
        from pdecontrolgym_jax.envs.wrappers import FlatObsEnv
        from pdecontrolgym_jax.rewards.ns import NSReward

        bc = freeze_boundary_condition({
            "upper": ["Controllable", "Dirchilet"],
            "lower": ["Dirchilet", "Dirchilet"],
            "left": ["Dirchilet", "Dirchilet"],
            "right": ["Dirchilet", "Dirchilet"],
        })
        n = 64
        ncfg = NavierStokesConfig(
            T=0.05, dt=2e-4, X=1.0, dx=1.0 / (n - 1), Y=1.0,
            dy=1.0 / (n - 1), viscosity=0.05, dtype=jnp.float32,
            boundary_condition=bc, pressure_solver="direct")
        U_ref, action_ref = make_lid_target(ncfg, lid=2.0)
        env = FlatObsEnv(NavierStokesEnv(ncfg, NSReward(0.1), U_ref,
                                         action_ref))
        sub_rate = 1  # NS: one PDE step per agent action
    else:
        from pdecontrolgym_jax.envs.common import Boundary1DConfig
        from pdecontrolgym_jax.envs.transport import TransportEnv
        from pdecontrolgym_jax.rewards.tuned import TunedReward1D

        # the bench.py transport config (BASELINE config 1): 1000 PDE
        # sub-steps per agent action
        cfg = Boundary1DConfig(
            T=5.0, dt=1e-4, X=1.0, dx=1.0 / nx,
            control_sample_rate=0.1,
            limit_pde_state_size=True, max_state_value=1e10,
        )
        env = TransportEnv(cfg, TunedReward1D(cfg.nt - 1, -1e3, 3e2))
        sub_rate = cfg.sample_rate
    if algo == "sac":
        from pdecontrolgym_jax.agents.sac import SACConfig, SACTrainer

        trainer = SACTrainer(env, SACConfig(
            num_envs=envs, steps_per_iter=num_steps,
            updates_per_iter=num_steps, batch_size=256,
            buffer_size=max(envs * 64, 4 * envs),
            hidden=(128, 128),
        ))
        return trainer, trainer.make_train_step(), "critic_loss", sub_rate
    from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer

    trainer = PPOTrainer(env, PPOConfig(
        num_envs=envs, num_steps=num_steps,
        num_epochs=4, num_minibatches=4, hidden=(128, 128),
    ))
    return trainer, trainer._train_step_local, "loss", sub_rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--num-steps", type=int, default=16)
    ap.add_argument("--inner", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--algo", default="ppo", choices=("ppo", "sac"))
    ap.add_argument("--env", default="transport", choices=("transport", "ns"),
                    help="ns: PPO/SAC on the 64x64 NS env (FlatObsEnv-"
                         "wrapped, policy consuming the flattened frames)")
    args = ap.parse_args()
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    trainer, step_fn, metric_key, sub_rate = build(
        args.env, args.algo, args.envs, args.num_steps, args.nx)
    steps_per_iter = args.num_steps
    runner = trainer.init(jax.random.key(0))

    @jax.jit
    def run(runner):
        def body(r, _):
            r, metrics = step_fn(r)
            return r, metrics[metric_key]
        runner, losses = jax.lax.scan(body, runner, None, length=args.inner)
        return runner, losses.sum()

    t0 = time.time()
    runner, s = jax.block_until_ready(run(runner))
    compile_s = time.time() - t0
    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        runner, s = jax.block_until_ready(run(runner))
        best = min(best, time.perf_counter() - t0)

    agent_steps = args.inner * args.envs * steps_per_iter
    rate = agent_steps / best
    tag = "" if args.env == "transport" else f" [{args.env}]"
    d = jax.devices()
    print(json.dumps({
        "metric": f"{args.algo} train env-steps/s (learner in loop){tag}",
        "envs": args.envs, "num_steps": args.num_steps,
        "agent_steps_per_s": round(rate),
        "pde_substeps_per_s": round(rate * sub_rate),
        "unit": "agent env-steps/s",
        "compile_s": round(compile_s, 1),
        "device": {"platform": d[0].platform, "kind": d[0].device_kind,
                   "count": len(d)},
    }), flush=True)


if __name__ == "__main__":
    main()
