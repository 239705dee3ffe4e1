"""Tensors made once from an index's tensors and kept beside them.

``derived(src, tag, make)`` returns ``make()``, made on the first call for
``src`` and ``tag`` (and again after ``src`` is written in place), then the
same tensor while ``src`` lives. A query pass may run inside a CUDA graph
capture, where a new tensor would come from the graph's private pool and a
host copy fails: a miss there raises, and the pass's eager warm-up before
the capture makes every entry it needs.
"""

from __future__ import annotations

import weakref

import torch

_MADE: dict = {}  # (id(src), tag) -> (weakref to src, src's version, the derived tensor)


def derived(src: torch.Tensor, tag: str, make) -> torch.Tensor:
    key = (id(src), tag)
    hit = _MADE.get(key)
    if hit is not None and hit[0]() is src and hit[1] == src._version:
        return hit[2]
    if src.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{tag} of a tensor was not made before this CUDA graph capture: "
                           "run the pass once eagerly first")
    out = make()
    _MADE[key] = (weakref.ref(src, lambda _: _MADE.pop(key, None)), src._version, out)
    return out
