"""Carry index state across from NumPy array dicts.

``arrays_from_numpy`` turns a ``device_arrays()`` dict — from this port's
builders or from ``mazu_tpu``'s — into the port's dict of tensors with the
same keys and layouts: u64/u32 arrays become int64/int32 bit patterns and
Meta records (and dataclass records such as the reference's BooPHF32 meta)
become the port's Meta.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._words import from_numpy
from .pytree import as_meta, meta


def arrays_from_numpy(host: dict, device) -> dict:
    out = {}
    for key, v in host.items():
        if isinstance(v, dict):
            out[key] = arrays_from_numpy(v, device)
        elif isinstance(v, np.ndarray):
            out[key] = from_numpy(v, device)
        elif hasattr(v, "kv"):
            out[key] = as_meta(v)
        elif dataclasses.is_dataclass(v):
            out[key] = meta(**{f.name: getattr(v, f.name) for f in dataclasses.fields(v)})
        else:
            raise TypeError(f"{key}: cannot carry {type(v).__name__} across")
    return out


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None. Raises when the result
    is a CUDA device and there is none: a build that was asked for the card
    does not fall back to the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the host")
    return dev


def words_to(words, device) -> torch.Tensor:
    """u64 k-mer words (any array-like) as int64 bit patterns on ``device``."""
    w = np.ascontiguousarray(np.asarray(words, dtype=np.uint64)).view(np.int64)
    return torch.from_numpy(w).to(device)
