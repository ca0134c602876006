"""Trivial-body floor analysis for the XLA-path env families.

Measures, for traffic ARZ, neuron and brain tumor, the ratio of the real
rollout rate to the rate of the IDENTICAL rollout harness (same policies,
lockstep autoreset, rewards, obs, termination/truncation logic) with the PDE
body replaced by one multiply:

- traffic: ``_substep`` → ``(0.9995·ρ, 0.9995·y)`` (the Richtmyer two-step
  midpoint scheme is the body; boundary writes, velocity reconstruction,
  reward and early-stop logic all stay);
- neuron: the in-``step`` moving-boundary DPR solve + embedded backstepping
  law → one multiply on (u, Z); observation masking, termination and the
  time-accumulator quirk stay;
- brain tumor: ``_fd_update`` + ``_radiation_field`` → one multiply / zeros;
  the simulated-MRI radius reductions and the 3-stage machine STAY — they
  are episode machinery every step must run, not the PDE body.

One JSON line per family:
    {"env": ..., "real": R, "floor": F, "ratio": R/F, ...}

A ratio near 1 means the family is machinery-bound (the PDE body is ~free —
optimizing it further is pointless); a low ratio means the body dominates
and a fused kernel could pay. GPU ratios: not measured yet (PERF.md).
"""

import argparse
import json

import jax
import jax.numpy as jnp

from bench_families import _measure
from pdecontrolgym_jax.core.base import StepOut


def _traffic(num_envs, repeats, steps):
    from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
    from pdecontrolgym_jax.rewards.traffic import TrafficARZReward

    class FloorEnv(TrafficARZEnv):
        def _substep(self, r, y, q_inlet, q_outlet):
            c = self.config
            return r * c.dtype(0.9995), y * c.dtype(0.9995)

    cfg = TrafficARZConfig(simulation_type="outlet")
    pair = []
    for cls in (TrafficARZEnv, FloorEnv):
        env = cls(cfg, TrafficARZReward())
        mid = jnp.asarray(0.5 * (env.action_low + env.action_high))
        policy = lambda obs, _key, mid=mid: jnp.full(obs.shape[:-1], mid)
        pair.append(_measure(env, policy, num_envs, steps or 960, repeats)[0])
    return pair


def _neuron(num_envs, repeats, steps):
    from pdecontrolgym_jax.envs.neuron import NeuronConfig, NeuronEnv

    class FloorEnv(NeuronEnv):
        def step(self, state, action=None, key=None):
            c = self.config
            t = state.time_index + c.dtype(c.dt)
            u_new = state.u * c.dtype(0.9995)
            Z_new = state.Z * c.dtype(1.0001)
            terminated = t >= c.nt
            truncated = jnp.logical_and(
                bool(c.limit_pde_state_size),
                jnp.linalg.norm(u_new) >= c.max_state_value,
            )
            new_state = state.replace(
                u=u_new, Z=Z_new,
                time_index=jnp.where(terminated, 0.0, t).astype(c.dtype),
            )
            return new_state, StepOut(
                obs=self._observe(u_new, state.L, key),
                reward=jnp.zeros((), c.dtype),
                terminated=terminated, truncated=truncated, info={},
            )

    cfg = NeuronConfig(dtype=jnp.float32)
    policy = lambda obs, _key: jnp.zeros(obs.shape[:-1])
    return [
        _measure(cls(cfg), policy, num_envs, steps or 1000, repeats)[0]
        for cls in (NeuronEnv, FloorEnv)
    ]


def _brain_tumor(num_envs, repeats, steps):
    from pdecontrolgym_jax.envs.brain_tumor import BrainTumorConfig, BrainTumorEnv
    from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward

    class FloorEnv(BrainTumorEnv):
        def _fd_update(self, u, R):
            return u * self.config.dtype(0.9995)

        def _radiation_field(self, u_prev, applied_dosage):
            return jnp.zeros_like(u_prev), jnp.zeros((), self.config.dtype)

    cfg = BrainTumorConfig()
    policy = lambda obs, _key: jnp.full(obs.shape[:-1], 0.5)
    return [
        _measure(cls(cfg, BrainTumorReward()), policy, num_envs,
                 steps or 365, repeats)[0]
        for cls in (BrainTumorEnv, FloorEnv)
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--families", default="traffic,neuron,brain_tumor")
    args = ap.parse_args()
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    fns = {"traffic": _traffic, "neuron": _neuron, "brain_tumor": _brain_tumor}
    for name in filter(None, args.families.split(",")):
        real, floor = fns[name](args.envs, args.repeats, args.steps)
        print(json.dumps({
            "env": name, "envs": args.envs,
            "real": round(real), "floor": round(floor),
            "ratio": round(real / floor, 3), "unit": "env-steps/s",
        }), flush=True)


if __name__ == "__main__":
    main()
