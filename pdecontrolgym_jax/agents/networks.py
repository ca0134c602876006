"""Policy / value networks for the on-device agents, in plain JAX.

The reference trains SB3 ``MlpPolicy`` (64x64 tanh MLPs) on CPU
(``transport1Dppo.py:88``). Here the same-capacity actor-critic is evaluated
in the rollout scan itself — observations never leave the device. Matmuls
run at JAX's default precision (TF32 on an H100's tensor cores).

Each network is a small object with ``init(key, *inputs) -> params`` and
``apply(params, *inputs)``. The parameter tree is
``{"params": {"Dense_<i>": {"kernel", "bias"}, ...}}``, dense layers numbered
in creation order, with the same initialisation (LeCun-normal kernels, zero
biases) and the same per-parameter keys as the Flax modules the committed
checkpoints (``examples/checkpoints/*.msgpack``) were trained with, so they
load unchanged.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


def _fold_in_path(key, path):
    """The key a parameter at ``path`` (module names, then the per-module
    parameter counter) receives: SHA-1 of the path folded into ``key``."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


def _dense_init(key, path, fan_in, fan_out):
    # a dense layer draws its kernel first (counter 1); the bias is zeros
    return {
        "kernel": _lecun_normal(_fold_in_path(key, (*path, 1)),
                                (fan_in, fan_out), jnp.float32),
        "bias": jnp.zeros((fan_out,), jnp.float32),
    }


def dense(p, x):
    return jnp.dot(x, p["kernel"]) + p["bias"]


def mlp_init(key, prefix, first, fan_in, widths):
    """Dense layers ``first, first+1, ...`` of widths ``widths``."""
    out = {}
    for i, w in enumerate(widths):
        name = f"Dense_{first + i}"
        out[name] = _dense_init(key, (*prefix, name), fan_in, w)
        fan_in = w
    return out


class ActorCritic:
    """Gaussian actor and value critic, two separate tanh MLPs, plus a
    state-independent ``log_std`` parameter."""

    def __init__(self, action_dim: int, hidden: Sequence[int] = (128, 128),
                 log_std_init: float = 0.0):
        self.action_dim = action_dim
        self.hidden = tuple(hidden)
        self.log_std_init = log_std_init

    def init(self, key, obs):
        h, n = self.hidden, len(self.hidden)
        p = mlp_init(key, (), 0, obs.shape[-1], h + (self.action_dim,))
        p["log_std"] = jnp.full((self.action_dim,), self.log_std_init,
                                jnp.float32)
        p.update(mlp_init(key, (), n + 1, obs.shape[-1], h + (1,)))
        return {"params": p}

    def apply(self, params, obs):
        p, n = params["params"], len(self.hidden)
        x = obs
        for i in range(n):
            x = jnp.tanh(dense(p[f"Dense_{i}"], x))
        mean = dense(p[f"Dense_{n}"], x)
        v = obs
        for i in range(n + 1, 2 * n + 1):
            v = jnp.tanh(dense(p[f"Dense_{i}"], v))
        value = dense(p[f"Dense_{2 * n + 1}"], v)
        return mean, p["log_std"], value.squeeze(-1)


def sample_action(mean, log_std, key):
    std = jnp.exp(log_std)
    noise = jax.random.normal(key, mean.shape, mean.dtype)
    action = mean + std * noise
    logp = gaussian_logp(action, mean, log_std)
    return action, logp


def gaussian_logp(action, mean, log_std):
    std = jnp.exp(log_std)
    z = (action - mean) / std
    return jnp.sum(
        -0.5 * z**2 - log_std - 0.5 * jnp.log(2.0 * jnp.pi), axis=-1
    )


def entropy(log_std):
    return jnp.sum(log_std + 0.5 * jnp.log(2.0 * jnp.pi * jnp.e), axis=-1)
