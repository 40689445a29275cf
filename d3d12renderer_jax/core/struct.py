"""Frozen dataclasses that are JAX pytrees.

`@dataclass` turns a class into a frozen dataclass registered with
`jax.tree_util.register_dataclass`.  Fields are pytree children unless they are
declared with `field(pytree_node=False)`; those are static metadata, part of
the tree structure and compared by value under `jit`.  Instances get
`.replace(**changes)`, which returns a copy with the named fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """`dataclasses.field` that also records whether the field is a child."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
