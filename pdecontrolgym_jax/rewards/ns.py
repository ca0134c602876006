"""NSReward — trajectory-tracking reward for the 2D Navier-Stokes env.

Reference: ``src/rewards/ns_reward.py:15-28`` (nonstandard signature):

    −½·‖U(t) − U_ref(t)‖² / (nx·ny)  −  (γ/2)·‖a − a_ref(t)‖²

Implemented as a RewardCtx callable (the NS env supplies the current frame,
reference frame and actions via ``ctx.extras``) plus the legacy signature.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from pdecontrolgym_jax.core.base import RewardCtx
from pdecontrolgym_jax.rewards.base import BaseReward


@dataclasses.dataclass(frozen=True)
class NSReward(BaseReward):
    gamma: float = 0.1

    def __call__(self, ctx: RewardCtx) -> jnp.ndarray:
        e = ctx.extras
        frame, ref = e["frame"], e["frame_ref"]
        nx, ny = frame.shape[-3], frame.shape[-2]
        track = jnp.sum(jnp.square(frame - ref)) / (nx * ny)
        act = jnp.sum(jnp.square(jnp.asarray(e["action"]) - e["action_ref"]))
        return -0.5 * track - self.gamma / 2.0 * act

    def reward(self, uVec, time_index, U_ref, action, action_ref):
        frame = uVec[time_index]
        track = jnp.sum(jnp.square(frame - U_ref[time_index]))
        track = track / uVec.shape[1] / uVec.shape[2]
        act = jnp.sum(jnp.square(jnp.asarray(action) - action_ref[time_index]))
        return -0.5 * track - self.gamma / 2.0 * act
