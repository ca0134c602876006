"""Reward protocol.

The reference defines an ABC ``BaseReward.reward(uVec, time_index, terminate,
truncate, action)`` operating on the full episode history buffer
(``src/rewards/base_reward.py:5-32``). The batched protocol instead passes a
:class:`~pdecontrolgym_jax.core.base.RewardCtx` of O(1) on-device running
statistics; rewards are frozen dataclasses with a pure ``__call__`` so they can
be closed over by jit (plug-in design preserved: envs accept any callable).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from pdecontrolgym_jax.core.base import RewardCtx


@dataclasses.dataclass(frozen=True)
class BaseReward:
    """Base class for plug-in rewards. Subclasses implement ``__call__``.

    ``ring_requirement`` tells the env how many trailing per-row L2 norms it
    must carry in state so the reward can look back in time (replacing the
    reference's full-history indexing like ``uVec[time_index - 100]``).
    """

    @property
    def ring_requirement(self) -> int:
        return 1

    @property
    def required_lags(self):
        """The exact norm lags this reward reads (e.g. ``(0, 100)``), or None
        meaning "any lag up to ring_requirement". Declaring them lets the env
        skip the cross-lane norm reduction on every other sub-step — the
        single largest cost in the 1D hot loop."""
        return None

    def __call__(self, ctx: RewardCtx) -> jnp.ndarray:
        raise NotImplementedError

    def reset(self) -> None:
        """No-op hook kept for API parity with ``base_reward.py:26-32``."""
