"""Throughput benchmark: aggregate 1D PDE env-steps/s at 4096 parallel envs.

BASELINE.json configs 1-2: transport nx=128 under the backstepping boundary
controller, and Burgers nx=256 under Dirichlet boundary control. Each rollout
is ONE jitted program (policy + control-interval scan over PDE sub-steps,
vmapped over the env batch); throughput counts PDE sub-steps, the unit the
reference's ``while`` loop executes per Python iteration
(``hyperbolic.py:140-156``). Needs a GPU; exits 1 without one.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": "env-steps/s", "vs_baseline": N,
     "device": {...}}
with vs_baseline relative to the 1e6 steps/s/host target in BASELINE.md.

The ``_build_*`` functions take config overrides (e.g. ``dtype``,
``backend``) so ``chip_smoke.py`` can build the same cells as references.
"""

import argparse
import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp


def _build_transport(num_envs, **overrides):
    from pdecontrolgym_jax.agents.backstepping import transport_kernel
    from pdecontrolgym_jax.envs.common import Boundary1DConfig
    from pdecontrolgym_jax.envs.transport import TransportEnv
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    nx = 128
    cfg = Boundary1DConfig(
        T=5.0, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.1,
        limit_pde_state_size=True, max_state_value=1e10, **overrides,
    )
    env = TransportEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt)), -1e3, 3e2))
    spatial = jnp.linspace(cfg.dx, cfg.X, nx)
    theta = (5.0 * jnp.cos(7.35 * jnp.arccos(jnp.clip(spatial, -1, 1)))).astype(jnp.float32)
    kernel = transport_kernel(theta, cfg.dx)

    def policy(obs, _key):
        # the backstepping law at full f32 (TF32 otherwise on an H100)
        return jnp.dot(obs, kernel, precision="highest") * cfg.dx

    agent_steps = 50  # one full episode: 50 actions x 1000 sub-steps
    return env, policy, agent_steps, cfg.sample_rate


def _build_burgers(num_envs, **overrides):
    from pdecontrolgym_jax.envs.burgers import BurgersConfig, BurgersEnv
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    nx = 256
    cfg = BurgersConfig(
        T=1.0, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.01,
        viscosity=1e-3, **overrides,
    )
    env = BurgersEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))

    def policy(obs, _key):
        return -0.5 * obs[..., -2]  # damp the boundary

    agent_steps = 100  # full episode: 100 actions x 100 sub-steps
    return env, policy, agent_steps, cfg.sample_rate


def bench_env(name, num_envs, repeats=3, inner=8):
    from pdecontrolgym_jax.parallel.rollout import rollout

    build = {
        "transport": _build_transport,
        "burgers": _build_burgers,
        "reaction_diffusion": _build_reaction_diffusion,
        "ns": _build_ns,
    }[name]
    env, policy, agent_steps, sample_rate = build(num_envs)

    # ONE device program returning a scalar: it scans ``inner`` full
    # episodes (fresh keys each — no CSE), timed with block_until_ready.
    def episode(key):
        return rollout(env, policy, num_envs, agent_steps, key)[1].reward.sum()

    def run_fn(key):
        acc, _ = jax.lax.scan(
            lambda a, k: (a + episode(k).astype(jnp.float32), ()),
            jnp.zeros((), jnp.float32),
            jax.random.split(key, inner),
        )
        return acc

    run = jax.jit(run_fn)
    jax.block_until_ready(run(jax.random.key(0)))  # compile + first run
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(jax.random.key(i)))
        best = min(best, time.perf_counter() - t0)
    substeps = num_envs * agent_steps * sample_rate * inner
    return substeps, best


def _build_reaction_diffusion(num_envs, **overrides):
    """BASELINE config 3: parabolic implicit scheme, nx=256, the DEFAULT
    solver (auto → pcr; on the GPU the interval kernel with the PCR
    elimination hoisted to once per interval; correct for any per-env β).
    Stable at 40x the explicit FTCS dt bound, so a control interval needs
    only 25 sub-steps."""
    from pdecontrolgym_jax.envs.reaction_diffusion import (
        ReactionDiffusionConfig,
        ReactionDiffusionEnv,
    )
    from pdecontrolgym_jax.rewards.tuned import TunedReward1D

    nx = 256
    cfg = ReactionDiffusionConfig(
        T=1.0, dt=4e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.01,
        scheme="implicit", theta=0.5, **overrides,
    )
    env = ReactionDiffusionEnv(cfg, TunedReward1D(int(round(cfg.T / cfg.dt))))

    def policy(obs, _key):
        return -0.1 * obs[..., -2]

    return env, policy, 100, cfg.sample_rate  # full episode


def _build_ns(num_envs, **overrides):
    """BASELINE config 5: 2D Navier-Stokes 64x64, fast mode = direct spectral
    pressure solve (XLA)."""
    import numpy as np

    from pdecontrolgym_jax.envs.navier_stokes import (
        NavierStokesConfig,
        NavierStokesEnv,
        freeze_boundary_condition,
    )
    from pdecontrolgym_jax.rewards.ns import NSReward

    n = 64
    bc = freeze_boundary_condition({
        "upper": ["Controllable", "Dirchilet"],
        "lower": ["Dirchilet", "Dirchilet"],
        "left": ["Dirchilet", "Dirchilet"],
        "right": ["Dirchilet", "Dirchilet"],
    })
    cfg = NavierStokesConfig(
        T=0.05, dt=2e-4, X=1.0, dx=1.0 / (n - 1), Y=1.0, dy=1.0 / (n - 1),
        boundary_condition=bc,
        dtype=jnp.float32, viscosity=0.05, pressure_solver="direct",
    )
    cfg = dataclasses.replace(cfg, **overrides)
    env = NavierStokesEnv(
        cfg, NSReward(0.1),
        np.zeros((cfg.nt, n, n, 2), cfg.dtype), np.zeros(cfg.nt, cfg.dtype),
    )

    def policy(obs, _key):
        return jnp.full((obs.shape[0], 1), 2.0)

    return env, policy, 20, 1  # 20 agent steps, 1 PDE step each


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--only", choices=["transport", "burgers", "reaction_diffusion", "ns"], default=None)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        print("bench.py measures the GPU; no GPU found", file=sys.stderr)
        sys.exit(1)
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.only == "ns":
        args.envs = min(args.envs, 2048)  # 64x64 fields; keep HBM sane
    names = [args.only] if args.only else ["transport", "burgers"]
    total_steps, total_time = 0.0, 0.0
    per = {}
    for name in names:
        steps, sec = bench_env(name, args.envs)
        per[name] = steps / sec
        total_steps += steps
        total_time += sec
        if args.verbose:
            print(f"# {name}: {steps / sec:,.0f} env-steps/s  ({sec * 1e3:.1f} ms/rollout)",
                  file=sys.stderr)

    value = total_steps / total_time
    labels = {
        "transport": "transport nx=128",
        "burgers": "Burgers nx=256",
        "reaction_diffusion": "reaction-diffusion implicit nx=256",
        "ns": "Navier-Stokes 64x64 direct-spectral-pressure",
    }
    desc = " + ".join(labels[n] for n in names)
    print(json.dumps({
        "metric": f"PDE env-steps/s/chip @ {args.envs} envs ({desc})",
        "value": round(value),
        "unit": "env-steps/s",
        "vs_baseline": round(value / 1e6, 3),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
