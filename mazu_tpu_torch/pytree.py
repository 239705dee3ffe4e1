"""Static metadata records for index array dicts.

Index structures are dicts of flat tensors plus one ``meta`` entry holding
geometry (bit widths, k, table sizes). Same record as ``mazu_tpu.pytree``,
without the jax registration.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Meta:
    kv: tuple

    def __getattr__(self, name):
        for k, v in object.__getattribute__(self, "kv"):
            if k == name:
                return v
        raise AttributeError(name)

    def replace(self, **kwargs) -> "Meta":
        d = dict(self.kv)
        d.update(kwargs)
        return Meta(tuple(sorted(d.items())))


def meta(**kwargs) -> Meta:
    """Build a Meta record; values must be hashable (ints, strs, tuples, or
    nested Meta)."""
    return Meta(tuple(sorted(kwargs.items())))


def as_meta(m) -> Meta:
    """A port Meta from any record with a ``kv`` tuple of (key, value)
    pairs — such as a ``mazu_tpu`` Meta, read without importing it."""
    if isinstance(m, Meta):
        return m
    return Meta(
        tuple((k, as_meta(v) if hasattr(v, "kv") else v) for k, v in m.kv)
    )
