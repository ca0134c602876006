"""The plain-JAX learner networks keep the parameter tree, the
initialisation and the forward pass of the Flax modules the committed
checkpoints were trained with."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pdecontrolgym_jax.agents.networks import ActorCritic
from pdecontrolgym_jax.agents.sac import Actor, TwinCritic


def _flax_modules():
    nn = pytest.importorskip("flax.linen")

    class FActorCritic(nn.Module):
        action_dim: int
        hidden: tuple

        @nn.compact
        def __call__(self, obs):
            x = obs
            for h in self.hidden:
                x = nn.tanh(nn.Dense(h)(x))
            mean = nn.Dense(self.action_dim)(x)
            log_std = self.param("log_std", nn.initializers.constant(0.0),
                                 (self.action_dim,), jnp.float32)
            v = obs
            for h in self.hidden:
                v = nn.tanh(nn.Dense(h)(v))
            return mean, log_std, nn.Dense(1)(v).squeeze(-1)

    class FActor(nn.Module):
        action_dim: int
        hidden: tuple

        @nn.compact
        def __call__(self, obs):
            x = obs
            for h in self.hidden:
                x = nn.relu(nn.Dense(h)(x))
            mean = nn.Dense(self.action_dim)(x)
            return mean, jnp.clip(nn.Dense(self.action_dim)(x), -5.0, 2.0)

    class Critic(nn.Module):
        hidden: tuple

        @nn.compact
        def __call__(self, obs, action):
            x = jnp.concatenate([obs, action], axis=-1)
            for h in self.hidden:
                x = nn.relu(nn.Dense(h)(x))
            return nn.Dense(1)(x).squeeze(-1)

    class FTwin(nn.Module):
        hidden: tuple

        @nn.compact
        def __call__(self, obs, action):
            return Critic(self.hidden)(obs, action), Critic(self.hidden)(obs, action)

    return FActorCritic, FActor, FTwin


@pytest.mark.parametrize("hidden", [(64, 64), (128, 32, 16)])
def test_networks_match_flax_init_and_apply(hidden):
    FActorCritic, FActor, FTwin = _flax_modules()
    key = jax.random.key(7)
    obs = jax.random.normal(jax.random.key(1), (5, 11), jnp.float32)
    act = jax.random.normal(jax.random.key(2), (5, 2), jnp.float32)
    pairs = [
        (ActorCritic(2, hidden), FActorCritic(2, hidden), (obs,)),
        (Actor(2, hidden), FActor(2, hidden), (obs,)),
        (TwinCritic(hidden), FTwin(hidden), (obs, act)),
    ]
    for ours, theirs, args in pairs:
        p, q = ours.init(key, *args), theirs.init(key, *args)
        assert jax.tree.structure(p) == jax.tree.structure(q)
        for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(q)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(ours.apply(p, *args)),
                        jax.tree.leaves(theirs.apply(q, *args))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
