"""Errors of the port (the ones of ``mazu_tpu.err`` it raises)."""

from __future__ import annotations


class MazuError(Exception):
    """Base error."""


class TruncatedFile(MazuError, IOError):
    """Binary file shorter than its declared contents."""


class InvalidData(MazuError, ValueError):
    """Malformed input data."""


class CfSeqTokenParseError(MazuError, ValueError):
    """Malformed cuttlefish tiling token."""


class EFNotMonotone(MazuError, ValueError):
    """Elias-Fano input sequence not monotone."""


class EFEmpty(MazuError, ValueError):
    """Elias-Fano of an empty sequence."""


class IndexLoad(MazuError, IOError):
    """Failed to load a serialized index."""
