"""Spatially sharded rollouts through the PUBLIC two-line API.

One PDE grid too large for a single core splits over the ``x`` mesh axis
while the env batch rides the ``env`` axis — `make_sharded_env` pins
`NamedSharding` constraints on the state pytree and XLA's SPMD partitioner
inserts the halo collectives for the stencils (docs/API.md "Spatial
sharding"; the explicit-`shard_map` construction of the same thing lives in
`parallel/spatial.py`'s make_spatial_* references).

Runs on an 8-virtual-device CPU mesh by default so it works anywhere:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/spatial_sharding_demo.py

On a multi-GPU host, drop the env pinning and pick `spatial_shards` to fit
the grid; everything else is identical.
"""

import os

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))

from pdecontrolgym_jax.envs.common import Boundary1DConfig
from pdecontrolgym_jax.envs.transport import TransportEnv
from pdecontrolgym_jax.parallel import (
    env_spatial_mesh,
    make_sharded_env,
    rollout,
)
from pdecontrolgym_jax.rewards.tuned import TunedReward1D


def main():
    nx = 4096  # one grid this size is ~the point of spatial sharding
    cfg = Boundary1DConfig(
        T=0.2, dt=1e-4, X=1.0, dx=1.0 / nx, control_sample_rate=0.01,
        backend="xla",  # the SPMD partitioner needs the XLA step path
    )
    env = TransportEnv(cfg, TunedReward1D(cfg.nt - 1))

    # the two lines:
    mesh = env_spatial_mesh(spatial_shards=2)
    senv = make_sharded_env(env, mesh)

    policy = lambda obs, key: -0.05 * obs[:, -1:]
    num_envs = 2 * mesh.shape["env"]
    (state, obs), outs = jax.jit(
        lambda k: rollout(senv, policy, num_envs, 10, k)
    )(jax.random.key(0))

    print(f"mesh axes: {dict(mesh.shape)}")
    print(f"state.u: shape {state.u.shape}, sharding {state.u.sharding.spec}")
    print(f"mean return over {num_envs} envs x 10 intervals: "
          f"{float(outs.reward.sum(0).mean()):.3f}")


if __name__ == "__main__":
    from pdecontrolgym_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
