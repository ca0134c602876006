"""Train PPO on ARZ traffic outlet boundary control (outlet-train mode).

Counterpart of the traffic tutorial's RL section
(``docs/source/tutorials/Trafficarz1d_tutorial.rst:199-266``: SB3 PPO, 2e6
steps, control_freq=2, stochastic steady-state resets). The policy sees the
normalized (ρ, v) deviations and outputs the outlet flux within the
[0.8q*, 1.2q*] box.
"""

import argparse

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.ppo import PPOConfig, PPOTrainer
from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
from pdecontrolgym_jax.rewards.traffic import TrafficARZReward


class PolicyActionTrafficEnv(TrafficARZEnv):
    """Maps [-1, 1] policy actions onto the flux action box."""

    def step(self, state, action, key=None):
        flux = self.action_low + (jnp.asarray(action) + 1.0) / 2.0 * (
            self.action_high - self.action_low
        )
        return super().step(state, flux.reshape(-1), key)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=200)
    args = ap.parse_args()

    cfg = TrafficARZConfig(simulation_type="outlet-train", control_freq=2)
    env = PolicyActionTrafficEnv(cfg, TrafficARZReward())
    trainer = PPOTrainer(
        env,
        PPOConfig(num_envs=128, num_steps=32, num_epochs=4, num_minibatches=8,
                  reward_scale=1.0, ent_coef=1e-3),
    )
    runner = trainer.init(jax.random.key(0))
    step = trainer.make_train_step()
    for it in range(args.iterations):
        runner, m = step(runner)
        if it % 10 == 0 or it == args.iterations - 1:
            m = jax.device_get(m)
            print(f"iter {it:4d}  mean_tracking_reward {m['mean_reward']:+.4f}",
                  flush=True)

    # closed-loop eval from a fresh episode
    policy = trainer.policy(runner.params)
    state, obs = env.init(jax.random.key(7))
    stepf = jax.jit(env.step)
    first = last = None
    for i in range(960):
        a = policy(obs[None])[0]
        state, out = stepf(state, a)
        obs = out.obs
        if first is None:
            first = float(out.reward)
        last = float(out.reward)
        if bool(out.terminated) or bool(out.truncated):
            break
    print(f"eval: tracking reward {first:+.4f} -> {last:+.4f} over {i+1} steps")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
