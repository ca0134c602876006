"""Model-based trajectory optimization for 2D Navier-Stokes boundary control.

JAX redesign of ``examples/NavierStokes/NS2Doptimization.py:56-118``:
the reference hand-derives and integrates an adjoint PDE backwards in time to
get action gradients. Here the whole rollout is differentiable, so the adjoint
IS ``jax.grad`` — one line — with ``jax.checkpoint`` rematerializing the
pressure solve to bound memory. Same objective (NSReward trajectory tracking),
same environment; the optimizer is Adam over the full action sequence.
"""

import numpy as np

import jax
import jax.numpy as jnp
import optax

from pdecontrolgym_jax.envs.navier_stokes import (
    NavierStokesConfig,
    NavierStokesEnv,
    freeze_boundary_condition,
)
from pdecontrolgym_jax.rewards.ns import NSReward

T, DT = 0.2, 1e-3
NT = int(round(T / DT))
BC = freeze_boundary_condition({
    "upper": ["Controllable", "Dirchilet"],
    "lower": ["Dirchilet", "Dirchilet"],
    "left": ["Dirchilet", "Dirchilet"],
    "right": ["Dirchilet", "Dirchilet"],
})


def build_env(U_ref, action_ref, iters=200):
    cfg = NavierStokesConfig(
        T=T, dt=DT, X=1.0, dx=0.05, Y=1.0, dy=0.05, action_dim=1,
        maximum_pressure_iteration=iters, boundary_condition=BC,
        dtype=jnp.float32,
    )
    return NavierStokesEnv(cfg, NSReward(0.1), U_ref, action_ref)


def rollout_return(env, actions, u0, v0, p0):
    state, _ = env.init_from(u0, v0, p0)
    step = jax.checkpoint(env.step)  # remat the 200-iteration pressure solve

    def body(state, a):
        state, out = step(state, a[None])
        return state, out.reward

    _, rewards = jax.lax.scan(body, state, actions)
    return rewards.sum()


def main():
    rng = np.random.default_rng(0)
    shape = (21, 21)
    u0 = jnp.asarray(rng.uniform(-1, 1) * np.ones(shape), jnp.float32)
    v0 = jnp.asarray(rng.uniform(-1, 1) * np.ones(shape), jnp.float32)
    p0 = jnp.asarray(rng.uniform(-1, 1) * np.ones(shape), jnp.float32)

    # --- generate the tracking target: a lid velocity of 2.0 (the reference's
    # target.npz is an equivalent precomputed lid-driven trajectory) ---------
    from pdecontrolgym_jax.envs.navier_stokes import make_lid_target

    env0 = build_env(np.zeros((NT, 21, 21, 2)), np.zeros(NT))
    U_ref, action_ref = make_lid_target(env0.config, lid=2.0,
                                        u0=u0, v0=v0, p0=p0)

    env = build_env(U_ref, action_ref)
    loss = jax.jit(
        lambda actions: -rollout_return(env, actions, u0, v0, p0)
    )
    grad = jax.jit(jax.grad(lambda a: -rollout_return(env, a, u0, v0, p0)))

    actions = jnp.asarray(rng.uniform(2, 4, NT - 1), jnp.float32)
    opt = optax.adam(0.2)
    opt_state = opt.init(actions)
    print(f"initial total reward: {-float(loss(actions)):.4f}")
    for it in range(30):
        g = grad(actions)
        updates, opt_state = opt.update(g, opt_state)
        actions = optax.apply_updates(actions, updates)
    final = -float(loss(actions))
    print(f"final total reward:   {final:.4f}")
    print(f"mean optimized action: {float(actions.mean()):.3f} (target lid 2.0)")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
