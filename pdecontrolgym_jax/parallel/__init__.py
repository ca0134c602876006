from pdecontrolgym_jax.parallel.mesh import (
    ENV_AXIS,
    env_mesh,
    env_sharding,
    replicated,
    shard_batch,
)
from pdecontrolgym_jax.parallel.rollout import batch_init, batch_step, rollout
from pdecontrolgym_jax.parallel.spatial import (
    X_AXIS,
    SpatialShardedEnv,
    env_spatial_mesh,
    make_sharded_env,
)

__all__ = [
    "ENV_AXIS",
    "X_AXIS",
    "SpatialShardedEnv",
    "batch_init",
    "batch_step",
    "env_mesh",
    "env_sharding",
    "env_spatial_mesh",
    "make_sharded_env",
    "replicated",
    "rollout",
    "shard_batch",
]
