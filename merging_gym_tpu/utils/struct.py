"""Frozen dataclasses that are JAX pytrees.

The package's configs and states are declared with ``@struct.dataclass``.
Fields are pytree leaves unless declared ``struct.field(pytree_node=False)``:
such a field is static metadata, kept in the treedef, so it must be
hashable and changing it retraces a jitted function.  ``.replace(**kw)``
returns a copy with fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass registered as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = dataclasses.replace
    return cls
