"""Throughput for the remaining env families: traffic ARZ, neuron, brain tumor.

``bench.py`` covers the BASELINE configs (transport + Burgers); this harness
measures the other families so every environment has a perf row
(docs/PERFORMANCE.md). Each rollout is one jitted program (policy + step,
vmapped over the env batch, in-kernel autoreset); timing is min-of-``repeats``
with ``block_until_ready``.

One JSON line per family:
    {"env": ..., "envs": B, "value": N, "unit": "env-steps/s", "device": ...}

Step semantics differ per family (matching the reference):
- traffic: one RL step = one Richtmyer PDE step (``traffic_arz_env.py``
  steps the PDE once per action).
- neuron: one step = one dt of the moving-boundary DPR solve; the control is
  the embedded backstepping law (action ignored), float32.
- brain_tumor: one step = one day (DPR PDE + BED dose); constant mid-range
  dose fraction.

The ``*_cell`` builders take config overrides (e.g. ``dtype``) so
``chip_smoke.py`` can build the same cells as float64 references.
"""

import argparse
import dataclasses
import json
import time

import numpy as np

import jax
import jax.numpy as jnp


def _device():
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _measure(env, policy, num_envs, num_steps, repeats, inner=8):
    from pdecontrolgym_jax.parallel.rollout import rollout

    # scan ``inner`` full episodes per dispatch (fresh keys — no CSE), so a
    # short family's episode is not dominated by one dispatch
    def episode(key):
        (_, obs), outs = rollout(env, policy, num_envs, num_steps, key)
        # fold the final observation into the timed scalar too: a reward-free
        # env (neuron embeds its controller and needs no reward here) would
        # otherwise time a constant-zero program after XLA dead-code
        # eliminates the entire rollout
        return outs.reward.sum().astype(jnp.float32) + obs.sum().astype(jnp.float32)

    def run_fn(key):
        acc, _ = jax.lax.scan(
            lambda a, k: (a + episode(k).astype(jnp.float32), ()),
            jnp.zeros((), jnp.float32),
            jax.random.split(key, inner),
        )
        return acc

    run = jax.jit(run_fn)
    t0 = time.time()
    jax.block_until_ready(run(jax.random.key(0)))
    compile_s = time.time() - t0
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(jax.random.key(i + 1)))
        best = min(best, time.perf_counter() - t0)
    return num_envs * num_steps * inner / best, compile_s


def traffic_cell(**overrides):
    """(env, policy, agent steps per episode)."""
    from pdecontrolgym_jax.envs.traffic_arz import TrafficARZConfig, TrafficARZEnv
    from pdecontrolgym_jax.rewards.traffic import TrafficARZReward

    cfg = TrafficARZConfig(simulation_type="outlet", **overrides)
    env = TrafficARZEnv(cfg, TrafficARZReward())
    mid = 0.5 * (env.action_low + env.action_high)

    def policy(obs, _key):
        return jnp.full(obs.shape[:-1], mid, obs.dtype)

    return env, policy, 960


def neuron_cell(steps_per_call=1, reward=False, **overrides):
    from pdecontrolgym_jax.envs.neuron import NeuronConfig, NeuronEnv
    from pdecontrolgym_jax.rewards.norm import NormReward

    cfg = NeuronConfig(**{"dtype": jnp.float32, **overrides},
                       steps_per_call=steps_per_call)
    env = NeuronEnv(cfg, reward=NormReward(nt=cfg.nt, norm_coeff=10.0)
                    if reward else None)
    policy = lambda obs, _key: jnp.zeros(obs.shape[:-1], obs.dtype)
    return env, policy, max(1000 // steps_per_call, 1)


def brain_tumor_cell(**overrides):
    from pdecontrolgym_jax.envs.brain_tumor import BrainTumorConfig, BrainTumorEnv
    from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward

    env = BrainTumorEnv(BrainTumorConfig(**overrides), BrainTumorReward())
    policy = lambda obs, _key: jnp.full(obs.shape[:-1], 0.5, obs.dtype)
    return env, policy, 365


def bench_traffic(num_envs, repeats, steps=None):
    env, policy, n = traffic_cell()
    return _measure(env, policy, num_envs, steps or n, repeats)


def bench_neuron(num_envs, repeats, steps=None):
    env, policy, n = neuron_cell()
    return _measure(env, policy, num_envs, steps or n, repeats)


def bench_neuron_kstep(num_envs, repeats, steps=None, reward=False):
    """The K-step path (steps_per_call=100): same 1000 dt-steps per episode
    as the `neuron` row, counted in dt-steps/s — the controller is embedded,
    so K>1 breaks no policy contract."""
    K = 100
    env, policy, calls = neuron_cell(steps_per_call=K, reward=reward)
    calls = max((steps or 1000) // K, 1)  # smoke --steps < K still measures
    rate, compile_s = _measure(env, policy, num_envs, calls, repeats)
    return rate * K, compile_s


def bench_neuron_kstep_reward(num_envs, repeats, steps=None):
    """The K-step path WITH the stock NormReward (per-dt L2 norm ring)."""
    return bench_neuron_kstep(num_envs, repeats, steps, reward=True)


def bench_brain_tumor(num_envs, repeats, steps=None):
    env, policy, n = brain_tumor_cell()
    return _measure(env, policy, num_envs, steps or n, repeats)


def bench_therapy(num_envs, repeats, steps=None):
    """TherapyEnv whole-episode throughput: batched init (in-kernel Growth
    fast-forward) + therapy days at a 1.8 Gy/day-equivalent dose fraction +
    the Post-Therapy sweep, loop until every env ends. The unit is simulated
    DAYS/s (sum of per-env simulation_days over wall time) — comparable to
    the brain_tumor env-steps/s row — with episodes/s derivable from the
    per-episode day count."""
    from pdecontrolgym_jax.envs.brain_tumor import (
        BrainTumorConfig, BrainTumorEnv, TherapyEnv)
    from pdecontrolgym_jax.rewards.brain_tumor import BrainTumorReward

    env = BrainTumorEnv(BrainTumorConfig(), BrainTumorReward())
    tenv = TherapyEnv(env, t_benchmark=300)
    dose = jnp.full((num_envs, 1), 0.03, jnp.float32)

    @jax.jit
    def episode(key):
        keys = jax.random.split(key, num_envs)
        state, _ = tenv.init_batch(keys)

        def cond(c):
            _, done = c
            return ~done.all()

        def body(c):
            s, done = c
            s, out = tenv.step_batch(s, dose)
            return s, done | out.terminated | out.truncated

        state, _ = jax.lax.while_loop(
            cond, body, (state, jnp.zeros((num_envs,), bool))
        )
        return state.simulation_days.sum()

    t0 = time.time()
    jax.block_until_ready(episode(jax.random.key(0)))
    compile_s = time.time() - t0
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        days = jax.block_until_ready(episode(jax.random.key(i + 1)))
        best = min(best, time.perf_counter() - t0)
    days = int(np.asarray(days))
    return days / best, compile_s


def ns_cell(solver="direct", n=64, **overrides):
    """NS cells. solver='matpow'/'jacobi' with n=None run the reference's
    21x21 grid at 2000-iteration pressure-parity semantics (matpow collapses
    the sweeps into two precomputed 441x441 matmuls with identical
    truncation error). solver='direct' is the fast mode: an f32 spectral
    solve at n x n."""
    from pdecontrolgym_jax.envs.navier_stokes import (
        NavierStokesConfig, NavierStokesEnv, freeze_boundary_condition)
    from pdecontrolgym_jax.rewards.ns import NSReward

    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"],
        "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"],
        "right": ["Dirchilet", "Dirchilet"],
    })
    if n is None:
        cfg = NavierStokesConfig(
            dtype=jnp.float32, boundary_condition=bc,
            pressure_solver=solver)
    else:
        cfg = NavierStokesConfig(
            T=0.05, dt=2e-4, X=1.0, dx=1.0 / (n - 1),
            Y=1.0, dy=1.0 / (n - 1), viscosity=0.05,
            dtype=jnp.float32, boundary_condition=bc,
            pressure_solver=solver)
    cfg = dataclasses.replace(cfg, **overrides)
    nt = cfg.nt
    env = NavierStokesEnv(
        cfg, NSReward(0.1),
        jnp.zeros((nt, cfg.ny, cfg.nx, 2), cfg.dtype),
        2.0 * jnp.ones(nt, cfg.dtype))
    policy = lambda obs, _key: jnp.full(obs.shape[:1] + (1,), 2.0, obs.dtype)
    return env, policy, nt - 1


def _bench_ns(solver, n=None):
    def run(num_envs, repeats, steps=None):
        env, policy, nsteps = ns_cell(solver, n)
        return _measure(env, policy, num_envs, steps or nsteps, repeats)

    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--steps", type=int, default=None,
                    help="override steps per rollout (smoke tests)")
    ap.add_argument("--families", default="traffic,neuron,brain_tumor,ns_matpow")
    args = ap.parse_args()
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    fns = {"traffic": bench_traffic, "neuron": bench_neuron,
           "neuron_kstep": bench_neuron_kstep,
           "neuron_kstep_reward": bench_neuron_kstep_reward,
           "brain_tumor": bench_brain_tumor,
           "therapy": bench_therapy,
           "ns_matpow": _bench_ns("matpow"), "ns_jacobi": _bench_ns("jacobi"),
           "ns_fast": _bench_ns("direct", n=64),
           "ns_fast_128": _bench_ns("direct", n=128)}
    for name in filter(None, args.families.split(",")):
        rate, compile_s = fns[name](args.envs, args.repeats, args.steps)
        print(json.dumps({
            "env": name, "envs": args.envs, "value": round(rate),
            "unit": "env-steps/s", "compile_s": round(compile_s, 1),
            "device": _device(),
        }), flush=True)


if __name__ == "__main__":
    main()
