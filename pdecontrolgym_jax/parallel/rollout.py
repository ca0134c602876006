"""Batched lockstep rollout engine: vmap over an env axis, scan over time.

The reference steps ONE Python env object per process (SB3 usage at
``examples/transportPDE/transport1Dppo.py:88-90``). Here thousands of envs run
in lockstep inside a single jitted program: done envs autoreset in-kernel from
the IC sampler, so the batch never stalls — the batched replacement for
vectorized env wrappers.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def env_noise_fn(env):
    """The innermost env's ``noise_fn``, walking functional wrapper chains
    (wrappers delegate through ``.env``). The PPO/SAC trainers gate their
    fused-rollout fast path on this: the fused ``batch_step`` drops per-env
    noise keys, so noisy envs must keep the per-env ``autoreset_step`` path —
    checking only the OUTERMOST object silently dropped sensing noise for
    wrapped envs (review finding)."""
    hops = 0
    while env is not None and hops < 16:
        fn = getattr(env, "noise_fn", None)
        if fn is not None:
            return fn
        env = getattr(env, "env", None)
        hops += 1
    return None


def _init_batch_fn(env):
    """``keys -> (state, obs)``: the env's fused ``init_batch`` (e.g.
    TherapyEnv's Growth fast-forward) when declared, else per-env vmap."""
    return getattr(env, "init_batch", None) or (
        lambda keys: jax.vmap(env.init)(keys)
    )


def batch_init(env, num_envs: int):
    """Returns ``init(key) -> (state, obs)`` for a batch of envs."""
    init_batch = _init_batch_fn(env)

    def init(key):
        return init_batch(jax.random.split(key, num_envs))

    return init


def batch_step(env, autoreset: bool = True):
    """Returns ``step(state, actions, key) -> (state, StepOut)`` (batched).

    Prefers the env's ``step_batch`` (the interval kernel where it runs)
    over per-env vmap; autoreset is applied generically on top.
    """
    has_batch = hasattr(env, "step_batch")

    def raw_step(state, actions):
        if has_batch:
            return env.step_batch(state, actions)
        return jax.vmap(env.step)(state, actions)

    if not autoreset:
        return lambda state, actions, key: raw_step(state, actions)

    def step(state, actions, key):
        next_state, out = raw_step(state, actions)
        done = jnp.logical_or(out.terminated, out.truncated)
        leaves = jax.tree_util.tree_leaves(state)
        n = leaves[0].shape[0]

        init_batch = _init_batch_fn(env)

        def do_reset(operand):
            next_state, out, key = operand
            fresh_state, fresh_obs = init_batch(jax.random.split(key, n))

            def sel(a, b):
                d = done.reshape(done.shape + (1,) * (a.ndim - done.ndim))
                return jnp.where(d, a, b)

            new_state = jax.tree_util.tree_map(sel, fresh_state, next_state)
            return new_state, out.replace(obs=sel(fresh_obs, out.obs))

        # Whether to branch-gate the reset work (fresh ICs + full-state
        # select) on "any env actually ended" is a size tradeoff:
        # - large-field envs (NS: 3 fresh (B,64,64) fields ≈ 49 KB/env)
        #   want the cond — re-sampling every step costs about as much as
        #   the projection step itself;
        # - small-state envs run ungated (a cond in the scan body blocks
        #   fusion and forces the whole carry to materialize around the
        #   branch). The 16 KB threshold has not been re-measured on the
        #   GPU (ROADMAP).
        # Shapes are static at trace time, so this picks one path per env.
        # An env whose IC sampler is itself expensive (e.g. brain tumor's
        # exp() field) can override the size heuristic by declaring
        # ``autoreset_gate = True`` (force the cond) or ``False``.
        def _nbytes(l):
            try:
                return l.size * l.dtype.itemsize
            except Exception:  # extended dtypes (PRNG keys) lack itemsize
                return l.size * 4

        gate = getattr(env, "autoreset_gate", None)
        if gate is None:
            per_env_bytes = sum(_nbytes(l) for l in leaves) // max(n, 1)
            gate = per_env_bytes >= 16384
        if not gate:
            return do_reset((next_state, out, key))

        def no_reset(operand):
            next_state, out, _ = operand
            return next_state, out

        return jax.lax.cond(done.any(), do_reset, no_reset, (next_state, out, key))

    return step


def rollout(
    env,
    policy_fn: Callable,
    num_envs: int,
    num_steps: int,
    key: jax.Array,
    autoreset: bool = True,
):
    """Collect a ``(num_steps, num_envs, ...)`` trajectory under ``policy_fn``.

    ``policy_fn(obs, key) -> actions`` is any pure mapping (a backstepping
    controller, an MLP policy, random actions). Returns final carry and
    stacked StepOut pytree.
    An env may declare ``fixed_episode_length = L`` (episodes ALWAYS
    terminate at exactly L steps and never truncate — e.g. Navier-Stokes,
    envs/navier_stokes.py). From a fresh init the batch is then lockstep
    forever, so resets only happen at exact episode boundaries where EVERY
    env resets at once: the scan is segmented there and the per-step masked
    autoreset (cond + full-state select, which costs ~2 extra carry round
    trips per step — more than the NS projection step itself) is dropped.
    """
    init = batch_init(env, num_envs)
    key, init_key = jax.random.split(key)
    state, obs = init(init_key)

    fixed_len = getattr(env, "fixed_episode_length", None) if autoreset else None
    # num_steps == 0 routes to the generic scan (a zero-length scan returns
    # an empty StepOut stack; the segment loop below would concatenate zero
    # pieces and crash).
    if fixed_len and num_steps > 0:
        return _rollout_fixed_len(
            env, policy_fn, num_envs, num_steps, key, int(fixed_len),
            state, obs,
        )

    step = batch_step(env, autoreset)
    keys = jax.random.split(key, num_steps)

    # An env whose observation is a pure function of state (no sensing
    # noise) can declare ``observe_batch(state)``: the scan then carries
    # ONLY the state and recomputes obs in-body — the carried obs select
    # (and its HBM round trip) drops out, and XLA dead-codes the recompute
    # whenever the policy ignores observation values. Correct under
    # autoreset too: the reset convention replaces state and obs together,
    # so observe(reset state) IS the fresh obs.
    observe = getattr(env, "observe_batch", None)
    if observe is not None:
        def body(state, step_key):
            act_key, env_key = jax.random.split(step_key)
            actions = policy_fn(observe(state), act_key)
            state, out = step(state, actions, env_key)
            return state, out

        state, outs = jax.lax.scan(body, state, keys)
        return (state, observe(state)), outs

    def body(carry, step_key):
        state, obs = carry
        act_key, env_key = jax.random.split(step_key)
        actions = policy_fn(obs, act_key)
        state, out = step(state, actions, env_key)
        return (state, out.obs), out

    (state, obs), outs = jax.lax.scan(body, (state, obs), keys)
    return (state, obs), outs


def _rollout_fixed_len(env, policy_fn, num_envs, num_steps, key, L,
                       state, obs):
    """Boundary-segmented rollout for ``fixed_episode_length`` envs.

    Semantics match the generic autoreset path exactly: the out at a
    boundary step keeps ``terminated=True`` but carries the fresh obs (the
    standard in-kernel autoreset convention), and the carry continues from
    the fresh state. Segmentation is static (num_steps and L are Python
    ints), so this stays one jitted program."""
    raw = batch_step(env, autoreset=False)
    # boundaries hit at step L, 2L, … ≤ num_steps; each consumes one extra
    # (reset) key. For num_steps < L the key stream is identical to the
    # generic path's split(key, num_steps), so the two paths match exactly.
    keys = jax.random.split(key, num_steps + num_steps // L)
    key_pos = 0

    # An env whose observation is a pure function of state (no sensing
    # noise) can declare ``observe_batch(state)``: the scan then carries ONLY
    # the state and recomputes obs in-body. This matters for NS's packed
    # fused mode — a carried obs would materialize the (B, ny, nx, 2) unpack
    # every step even when the policy ignores observation values; recomputed
    # in-body, XLA dead-codes it instead.
    observe = getattr(env, "observe_batch", None)

    def plain_segment(state, obs, seg_keys):
        if observe is not None:
            def body(state, step_key):
                actions = policy_fn(observe(state), jax.random.split(step_key)[0])
                state, out = raw(state, actions, None)
                return state, out

            state, outs = jax.lax.scan(body, state, seg_keys)
            # == the last step's out.obs (observe is a pure fn of state) but
            # does not force the stacked per-step obs buffer live
            return (state, observe(state)), outs

        def body(carry, step_key):
            state, obs = carry
            actions = policy_fn(obs, jax.random.split(step_key)[0])
            state, out = raw(state, actions, None)
            return (state, out.obs), out

        return jax.lax.scan(body, (state, obs), seg_keys)

    pieces = []
    t, pos = 0, 0
    while pos < num_steps:
        k = min(L - 1 - t, num_steps - pos)
        if k > 0:
            (state, obs), outs = plain_segment(
                state, obs, keys[key_pos : key_pos + k]
            )
            pieces.append(outs)
            t += k
            pos += k
            key_pos += k
        if pos >= num_steps:
            break
        # boundary step: every env terminates here; step, then re-init all
        step_key = keys[key_pos]
        key_pos += 1
        actions = policy_fn(obs, jax.random.split(step_key)[0])
        state, out = raw(state, actions, None)
        reset_keys = jax.random.split(keys[key_pos], num_envs)
        key_pos += 1
        state, obs = jax.vmap(env.init)(reset_keys)
        out = out.replace(obs=obs)
        pieces.append(jax.tree_util.tree_map(lambda x: x[None], out))
        t = 0
        pos += 1
    outs = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *pieces
    )
    return (state, obs), outs
