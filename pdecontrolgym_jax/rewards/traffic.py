"""TrafficARZReward — relative-L2 tracking penalty for the ARZ traffic env.

Reference: ``src/rewards/traffic_arz_reward.py:12-22`` (nonstandard signature
``reward(v_desired, r_desired, v, r)``):

    −( ‖v − v*‖₂ / v*  +  ‖ρ − ρ*‖₂ / ρ* )

Implemented both as a RewardCtx callable (functional path; the traffic env
passes v/r/v*/ρ* through ``ctx.extras``) and as a legacy-signature ``reward``
method so user code written against the reference ABC keeps working.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from pdecontrolgym_jax.core.base import RewardCtx
from pdecontrolgym_jax.rewards.base import BaseReward


def _l2(x):
    return jnp.sqrt(jnp.sum(jnp.square(x)))


@dataclasses.dataclass(frozen=True)
class TrafficARZReward(BaseReward):
    def __call__(self, ctx: RewardCtx) -> jnp.ndarray:
        e = ctx.extras
        return self.reward(e["vs"], e["rs"], e["v"], e["r"])

    def reward(self, v_desired, r_desired, v, r):
        return -(
            _l2(v - v_desired) / v_desired + _l2(r - r_desired) / r_desired
        )
