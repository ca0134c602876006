"""Pure-functional environment protocol for batched PDE control.

The reference (lukebhan/PDEControlGym) is an imperative Gymnasium package whose
environments mutate a full ``(nt, nx)`` history buffer in ``step()``
(``pde_control_gym/src/environments1d/base_env_1d.py:41``). Here that design
is replaced by a *pure functional* protocol:

    env.init(key)                  -> (state, obs)
    env.step(state, action, key)   -> (state', StepOut)

where ``state`` is a small pytree carrying only the *current* PDE row plus O(1)
running accumulators (the reward statistics the reference recomputes from its
history buffer). Everything is jit-able, vmap-able over an env axis, and
shard_map-able over a device mesh. Episode ends are masked (autoreset) rather
than control flow.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.core import pytree


@pytree.dataclass
class StepOut:
    """The 5-tuple of a Gymnasium step, as a pytree.

    Mirrors the return contract of the reference envs' ``step``
    (e.g. ``hyperbolic.py:159-169``): (obs, reward, terminated, truncated, info).
    """

    obs: jnp.ndarray
    reward: jnp.ndarray
    terminated: jnp.ndarray
    truncated: jnp.ndarray
    info: dict[str, Any] = pytree.field(default_factory=dict)


@pytree.dataclass
class RewardCtx:
    """Everything a plug-in reward function may need, computed on-device.

    The reference passes its full ``(nt, nx)`` history buffer into
    ``BaseReward.reward(uVec, time_index, terminate, truncate, action)``
    (``src/rewards/base_reward.py:13-24``). This engine instead carries O(1)
    running statistics:

    - ``norms``: the TRAILING window of per-row L2 norms — ``norms[-1]`` is
      the current row, ``norms[-1-k]`` the row k sub-steps earlier. The window
      width is ``reward.ring_requirement + 1``, so every lag a reward declares
      is resolvable. (Computing a norm every sub-step is the throughput
      bottleneck — a cross-lane reduction per step — so the engines compute
      only this window per control interval; see envs/common.py.)
    - ``bsum``: running sum of ``|u[t, -1]|`` over all rows written so far
      (replaces the reference's ``np.sum(abs(uVec[:, -1]))``,
      ``tuned_reward_1d.py:37``).
    """

    u: jnp.ndarray
    time_index: jnp.ndarray
    executed: jnp.ndarray
    terminated: jnp.ndarray
    truncated: jnp.ndarray
    action: jnp.ndarray
    norms: jnp.ndarray
    bsum: jnp.ndarray
    ring: int = pytree.field(pytree_node=False, default=1)
    extras: Any = None
    # trailing window of per-row norms in a reward-declared ord (reward's
    # ``ring_ord``, e.g. L1/L∞ for NormReward t-horizon) — None unless the
    # reward declares an ord other than "2" (the L2 ``norms`` window always
    # exists: truncation reads it)
    aux_norms: Any = None

    def _at(self, back, ring=None):
        # clamp under-declared lags to the window's oldest entry instead of
        # silently wrapping via negative indexing
        ring = self.norms if ring is None else ring
        idx = ring.shape[-1] - 1 - back
        if isinstance(back, int):
            idx = max(idx, 0)  # static — keeps the indexing gather-free
        else:
            idx = jnp.maximum(idx, 0)
        return ring[..., idx]

    @property
    def cur_norm(self) -> jnp.ndarray:
        """L2 norm of the current PDE row (``np.linalg.norm(uVec[time_index])``).

        Exact on every interval including partial terminal ones: frozen
        sub-steps re-evaluate the unchanged row's norm into the final window
        slot.
        """
        return self._at(0)

    def norm_at_lag(self, lag) -> jnp.ndarray:
        """L2 norm of the row ``lag`` sub-steps before the current one.

        Exact on fully-executed control intervals — every step of every
        reference configuration (their intervals divide the horizon). On a
        PARTIAL terminal interval (non-dividing configs only) lag-targeted
        norm skipping means the historical row's norm was never evaluated;
        the read then returns the frozen current-row norm recorded at the
        lag's offset class instead. Terminal bonuses/penalties (the usual
        terminal rewards) don't read lags; only the TunedReward fall-through
        with an oversized terminal state observes this.
        """
        return self._at(lag)


RewardFn = Callable[[RewardCtx], jnp.ndarray]


class FunctionalEnv:
    """Base class for pure functional PDE control environments.

    Instances hold only *static* configuration (Python scalars / strings /
    small callables). All dynamic data lives in the state pytree, so bound
    methods can be closed over by ``jax.jit`` and traced once per config.
    """

    def init(self, key: jax.Array):
        """Sample a fresh episode. Returns ``(state, obs)``."""
        raise NotImplementedError

    def step(self, state, action, key: Optional[jax.Array] = None):
        """Advance one control interval. Returns ``(state, StepOut)``."""
        raise NotImplementedError

    # -- conveniences -------------------------------------------------------

    def autoreset_step(self, state, action, key: jax.Array):
        """Step with in-kernel autoreset: finished episodes re-init from the
        IC sampler instead of requiring host control flow (lockstep batching).

        Returns ``(state, StepOut)`` where ``StepOut`` reports the *pre-reset*
        transition (terminated/truncated flags refer to the finishing episode)
        and the returned state/obs belong to the fresh episode when done.
        """
        step_key, reset_key = jax.random.split(key)
        next_state, out = self.step(state, action, step_key)
        done = jnp.logical_or(out.terminated, out.truncated)
        fresh_state, fresh_obs = self.init(reset_key)
        sel = lambda a, b: jnp.where(
            jnp.reshape(done, (1,) * a.ndim if a.ndim else ()), a, b
        )
        new_state = jax.tree_util.tree_map(sel, fresh_state, next_state)
        new_obs = sel(fresh_obs, out.obs)
        return new_state, out.replace(obs=new_obs)


def roll_ring(ring: jnp.ndarray, fresh: jnp.ndarray, executed) -> jnp.ndarray:
    """Advance a ring of the last ``len(ring)`` per-row statistics.

    ``fresh`` holds one entry per sub-step of the current control interval of
    which only the first ``executed`` are valid. The concatenation
    ``[ring, fresh]`` is a contiguous timeline, so the new ring is simply a
    dynamic slice of length ``len(ring)`` starting at ``executed``.
    """
    allv = jnp.concatenate([ring, fresh])
    return jax.lax.dynamic_slice(allv, (executed,), (ring.shape[0],))
