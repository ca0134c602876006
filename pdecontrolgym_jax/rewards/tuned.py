"""TunedReward1D — the benchmark-paper reward for the 1D boundary-control envs.

Semantics replicated from ``src/rewards/tuned_reward_1d.py:25-40``:

- terminal step with ``‖u(T)‖ < 20``:
  ``terminate_reward − Σ_t |u(t, -1)|/1000 − ‖u(T)‖``
- truncation: ``truncate_penalty · (nt − time_index)``
- otherwise: ``‖u(t − L)‖ − ‖u(t)‖`` where ``L = int(1/0.01) = 100`` sub-steps
  (the reference env calls ``reward`` positionally so the reward's own
  ``control_sample_rate`` argument always takes its default 0.01 —
  ``hyperbolic.py:165`` vs ``tuned_reward_1d.py:25``).

All history terms come from O(1) running accumulators in RewardCtx rather than
the reference's full ``(nt, nx)`` buffer.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from pdecontrolgym_jax.core.base import RewardCtx
from pdecontrolgym_jax.rewards.base import BaseReward


@dataclasses.dataclass(frozen=True)
class TunedReward1D(BaseReward):
    nt: int
    truncate_penalty: float = -1e-4
    terminate_reward: float = 1e2
    lookback: int = 100  # = int(1 / reward-default control_sample_rate of 0.01)

    @property
    def ring_requirement(self) -> int:
        return self.lookback

    @property
    def required_lags(self):
        return (0, self.lookback)

    def __call__(self, ctx: RewardCtx) -> jnp.ndarray:
        cur = ctx.cur_norm
        prev = ctx.norm_at_lag(self.lookback)
        r_terminate = self.terminate_reward - ctx.bsum / 1000.0 - cur
        r_truncate = self.truncate_penalty * (self.nt - ctx.time_index)
        r_running = prev - cur
        # Branch order matches the reference: terminal bonus is gated on the
        # norm; an oversized terminal state falls through to the running term.
        return jnp.where(
            jnp.logical_and(ctx.terminated, cur < 20.0),
            r_terminate,
            jnp.where(ctx.truncated, r_truncate, r_running),
        )
