"""Frozen dataclasses registered as JAX pytrees.

Subclassing :class:`PyTreeNode` turns a class body of annotated fields into a
frozen dataclass whose fields are pytree leaves, except those declared with
``field(pytree_node=False)``, which become static metadata (part of the jit
cache key).  ``replace`` returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    return dataclasses.field(metadata={"static": not pytree_node}, **kwargs)


class PyTreeNode:
    """Base class: subclasses become frozen dataclasses and pytrees."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields if not f.metadata.get("static")],
            meta_fields=[f.name for f in fields if f.metadata.get("static")],
        )

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
