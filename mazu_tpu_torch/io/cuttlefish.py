"""Cuttlefish "reduced GFA" input (counterpart of ``mazu_tpu.io.cuttlefish``).

Files for prefix P: ``P.cf_seg`` (``unitig id<TAB>seq`` lines), ``P.cf_seq``
(a reference's tiling a line: ``name<TAB>token token ...``, a token being
``<cfid>+``, ``<cfid>-`` or ``N<len>``) and ``P.json`` (k, unitig count and
total length).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterator

from .. import ORIENT_BACKWARD, ORIENT_FORWARD
from ..err import CfSeqTokenParseError


class CfFiles:
    def __init__(self, prefix: str):
        self.segs = prefix + ".cf_seg"
        self.tiling = prefix + ".cf_seq"
        self.json = prefix + ".json"


class CfInfo:
    def __init__(self, d: dict):
        self.d = d

    @classmethod
    def from_path(cls, path: str) -> "CfInfo":
        with open(path) as f:
            return cls(json.load(f))

    @property
    def k(self) -> int:
        return self.d["parameters info"]["k"]

    @property
    def n_unitigs(self) -> int:
        return self.d["contigs info"]["maximal unitig count"]

    @property
    def total_len(self) -> int:
        return self.d["contigs info"]["sum maximal unitig length"]


@dataclass(frozen=True)
class CfSeqToken:
    """A run of N (is_unitig False, ``n`` its length) or a unitig
    occurrence (``id`` its cuttlefish id, ``o`` its orientation)."""

    is_unitig: bool
    n: int = 0
    id: int = 0
    o: int = ORIENT_FORWARD

    @classmethod
    def parse(cls, s: str) -> "CfSeqToken":
        try:
            if s.startswith("N"):
                return cls(False, n=int(s[1:]))
            o = ORIENT_FORWARD if s[-1] == "+" else ORIENT_BACKWARD
            return cls(True, id=int(s[:-1]), o=o)
        except (ValueError, IndexError) as e:
            raise CfSeqTokenParseError(f"bad cf_seq token {s!r}") from e


def iter_segs(cf: CfFiles) -> Iterator[tuple[int, str]]:
    """Yield (cuttlefish id, sequence) per ``.cf_seg`` line."""
    with open(cf.segs) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            cfid, seq = line.split("\t", 1)
            yield int(cfid), seq


def iter_tiling(cf: CfFiles) -> Iterator[tuple[str, list[CfSeqToken]]]:
    """Yield (reference name, tokens) per ``.cf_seq`` line."""
    with open(cf.tiling) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            name, toks = line.split("\t", 1)
            yield name, [CfSeqToken.parse(t) for t in toks.split(" ")]
