"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` makes a frozen dataclass and registers it with
``jax.tree_util.register_dataclass``: every field is a pytree child except
those declared ``field(pytree_node=False)``, which are static (part of the
tree structure, hashed by ``jit``). Instances get ``.replace(**changes)``.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
