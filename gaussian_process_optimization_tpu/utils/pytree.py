"""Pytree-dataclass helpers.

The reference builds its models on the `paramz` observer/Param machinery
(``GPy/GPy/core/parameterization/``). The JAX-native replacement is a functional design:
models and kernels are immutable frozen dataclasses registered as JAX pytrees; parameters
are ordinary array leaves, so `jax.grad`/`vmap`/`jit` traverse them directly and there is
no observer pattern or caching layer (XLA CSE plays that role).
"""
from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T")


def static_field(**kwargs) -> Any:
    """A dataclass field treated as pytree metadata (static under jit)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree_dataclass(cls: type[T]) -> type[T]:
    """Frozen dataclass registered as a JAX pytree.

    Fields declared with :func:`static_field` become aux data (hashable, static under
    jit); all other fields are child leaves.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    return cls


def replace(obj: T, **changes) -> T:
    return dataclasses.replace(obj, **changes)
