"""NormReward — L1/L2/L∞ norm rewards with three horizon modes.

Reference: ``src/rewards/norm_reward.py:5-73``. That implementation is broken
at runtime (undefined ``norm_coeff`` at lines 54/59/61/73, array-vs-None
``==`` at line 41, and a *string* ``ord`` passed to ``np.linalg.norm`` at line
54). This is the repaired batched version, with the documented semantics:

- ``temporal``: ``-‖u(t)‖ / norm_coeff``
- ``differential``: ``+‖u(t) − u(t−1)‖ / norm_coeff`` for t>0 (the reference
  returns the *positive* difference norm; preserved), else the temporal value.
- ``t-horizon``: ``-(1/H) Σ_{i<H} ‖u(t−i)‖ / norm_coeff``, averaging over
  ``min(H, t)`` rows near episode start.

``norm_coeff`` is exposed as a constructor parameter (default 1.0) since the
reference never defines it. Terminate/truncate bonuses match
``norm_reward.py:47-50``.

The differential and t-horizon modes need trailing per-row statistics:
differential requires the previous full row, which the 1D envs carry
(``prev_u``) when the reward requests it via ``needs_prev_row``; t-horizon
reads lagged per-row norms from the env's trailing ring — the L2 ring when
``norm="2"``, else an auxiliary ring the env evaluates in this reward's
declared ``ring_ord`` (L1/L∞) alongside the L2 one truncation reads.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from pdecontrolgym_jax.core.base import RewardCtx
from pdecontrolgym_jax.rewards.base import BaseReward

_ORDS = {"1": 1, "2": 2, "inf": jnp.inf, 1: 1, 2: 2}


def _vec_norm(x, ord_key):
    o = _ORDS[ord_key]
    if o == 1:
        return jnp.sum(jnp.abs(x), axis=-1)
    if o == 2:
        return jnp.sqrt(jnp.sum(jnp.square(x), axis=-1))
    return jnp.max(jnp.abs(x), axis=-1)


@dataclasses.dataclass(frozen=True)
class NormReward(BaseReward):
    nt: int
    norm: str = "2"
    horizon: str = "temporal"
    truncate_penalty: float = -1e-4
    terminate_reward: float = 1e2
    t_horizon_length: int = 5
    norm_coeff: float = 1.0

    def __post_init__(self):
        if self.nt is None:
            raise ValueError(
                "Number of simulation steps must be specified in the NormReward class."
            )
        if str(self.norm) not in ("1", "2", "inf"):
            raise ValueError(f"Invalid norm {self.norm!r}; use '1', '2' or 'inf'.")
        if self.horizon not in ("temporal", "differential", "t-horizon"):
            raise ValueError(f"Invalid horizon {self.horizon!r}.")

    @property
    def ring_requirement(self) -> int:
        if self.horizon == "t-horizon":
            return max(self.t_horizon_length, 1)
        return 1

    @property
    def ring_ord(self) -> str:
        """Norm ord of the trailing window this reward reads lags from.
        For L1/L∞ t-horizon the env carries an auxiliary window in this ord
        next to the L2 one (truncation always reads L2)."""
        return str(self.norm) if self.horizon == "t-horizon" else "2"

    @property
    def required_lags(self):
        if self.horizon == "t-horizon":
            return tuple(range(self.t_horizon_length))
        return (0,)

    @property
    def needs_prev_row(self) -> bool:
        # L2 differential can be served by the norm ring only when comparing
        # rows, not norms — the difference norm always needs the previous row.
        return self.horizon == "differential"

    def __call__(self, ctx: RewardCtx) -> jnp.ndarray:
        cur_norm = _vec_norm(ctx.u, str(self.norm))

        if self.horizon == "temporal":
            running = -cur_norm / self.norm_coeff
        elif self.horizon == "differential":
            prev_u = ctx.extras["prev_u"]
            diff = _vec_norm(ctx.u - prev_u, str(self.norm)) / self.norm_coeff
            running = jnp.where(ctx.time_index > 0, diff, -cur_norm / self.norm_coeff)
        else:  # t-horizon (trailing window in this reward's ord)
            h = self.t_horizon_length
            lags = jnp.arange(h)
            ring = ctx.norms if str(self.norm) == "2" else ctx.aux_norms
            vals = ctx._at(lags, ring)
            count = jnp.minimum(jnp.maximum(ctx.time_index, 1), h)
            mask = lags < count
            running = -jnp.sum(jnp.where(mask, vals, 0.0)) / count / self.norm_coeff

        return jnp.where(
            ctx.terminated,
            jnp.asarray(self.terminate_reward, cur_norm.dtype),
            jnp.where(
                ctx.truncated,
                self.truncate_penalty * (self.nt - ctx.time_index),
                running,
            ),
        )
