"""Frozen dataclasses that are JAX pytrees.

`dataclass` registers the class with `jax.tree_util.register_dataclass`:
array fields are pytree children, fields declared with
``field(static=True)`` are treedef metadata. Static values must be
hashable; two instances with equal statics share a jit cache entry.
"""
from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the pytree leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = dataclasses.replace
    return cls
