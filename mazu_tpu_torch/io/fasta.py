"""Multi-line FASTA reader (counterpart of ``mazu_tpu.io.fasta``): the
header text after '>' verbatim, sequence lines concatenated, no case or N
processing (the caller's choice)."""

from __future__ import annotations

import gzip
from typing import Iterator


def open_text(path: str):
    """Open a text file, gunzipping ``*.gz``."""
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def open_binary(path: str):
    """Binary form of ``open_text``."""
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) per record."""
    name = None
    chunks: list[str] = []
    with open_text(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)
