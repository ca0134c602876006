"""Device-mesh utilities: env-axis data parallelism over the cards.

The reference has no distributed backend of any kind (SURVEY §2.3/§5). The
scaling axis for this workload is the batch-of-envs dimension: envs shard
over a 1D ``("env",)`` mesh, the learner's parameters replicate, and
gradients reduce with ``pmean`` inside ``shard_map`` — XLA inserts the
collectives (NCCL on GPUs, over NVLink within a host; across hosts after
``jax.distributed.initialize``). The mesh is a flat device list: every card
of an NVLink host reaches every other at the same rate, so only the
algorithm shapes it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


ENV_AXIS = "env"


def env_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1D mesh over all (or the given) devices with a single env axis."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (ENV_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (env-batch) axis over the mesh."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Device-put a batch pytree with its leading axis sharded over the mesh."""
    sh = env_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def multihost_env_mesh(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_collectives: str = "gloo",
) -> Mesh:
    """Initialize multi-process JAX and return the global env mesh. On a
    single process this is just :func:`env_mesh`.

    Each process steps its env shard in lockstep; the learner's gradients
    ``pmean`` across the whole mesh (agents/ppo.py), which XLA lowers to
    the platform's collectives (Gloo on the CPU, NCCL on GPUs).

    Executed end-to-end by ``examples/multihost_demo.py`` /
    ``tests/test_multiprocess.py``: 2 localhost CPU processes (Gloo
    cross-process collectives) drive the sharded PPO train step — see
    MULTIHOST.md for a recorded run.
    """
    if coordinator_address is not None:
        try:
            # CPU cross-process collectives need an explicit implementation;
            # must be set before the backend initializes; ignored on GPUs.
            jax.config.update("jax_cpu_collectives_implementation",
                              cpu_collectives)
        except Exception:
            pass  # older/newer jax without this option
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return env_mesh()


def put_global(tree, mesh: Mesh, spec) -> "jax.Array":
    """Place host-replicated pytree leaves onto a mesh sharding, working in
    BOTH single-process and multi-process (``jax.distributed``) programs.

    Every process must pass the same full (global) value — the standard
    pattern for deterministic same-seed initialization. Single-process this
    is plain ``device_put``; multi-process, ``device_put`` rejects
    non-addressable shardings, so each leaf is assembled from per-device
    blocks with ``jax.make_array_from_callback`` (each process materializes
    only the blocks it owns). Typed PRNG-key leaves are routed through
    ``key_data``/``wrap_key_data`` (numpy cannot hold extended dtypes).
    """
    sh = spec if isinstance(spec, NamedSharding) else NamedSharding(mesh, spec)

    def put(x):
        if sh.is_fully_addressable:
            return jax.device_put(x, sh)
        if jnp.issubdtype(getattr(x, "dtype", None), jax.dtypes.prng_key):
            kd = np.asarray(jax.device_get(jax.random.key_data(x)))
            arr = jax.make_array_from_callback(
                kd.shape, sh, lambda idx: kd[idx]
            )
            return jax.random.wrap_key_data(arr)
        x = np.asarray(jax.device_get(x))
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    return jax.tree_util.tree_map(put, tree)
