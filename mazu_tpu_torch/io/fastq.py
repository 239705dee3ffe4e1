"""FASTQ reader (counterpart of ``mazu_tpu.io.fastq``): multi-line records
and gzip (``*.gz``). Quality strings frame the records and are not
returned."""

from __future__ import annotations

from typing import Iterator

from ..err import InvalidData
from .fasta import open_text, read_fasta


def read_fastq(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence). A multi-line quality block must cover exactly
    the sequence length."""
    with open_text(path) as f:
        it = iter(f)
        for header in it:
            header = header.rstrip("\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise InvalidData(f"{path}: FASTQ record must start with '@', got {header[:20]!r}")
            chunks: list[str] = []
            plus_seen = False
            qlen = 0
            for line in it:
                line = line.rstrip("\n")
                if not plus_seen:
                    if line.startswith("+"):
                        plus_seen = True
                    else:
                        chunks.append(line)
                else:
                    qlen += len(line)
                    slen = sum(map(len, chunks))
                    if qlen >= slen:
                        if qlen != slen:
                            raise InvalidData(
                                f"{path}: quality length {qlen} != sequence length {slen}"
                            )
                        break
            else:
                if not plus_seen or qlen != sum(map(len, chunks)):
                    raise InvalidData(f"{path}: truncated FASTQ record {header[:20]!r}")
            yield header[1:], "".join(chunks)


def read_seqs(path: str) -> Iterator[tuple[str, str]]:
    """FASTA or FASTQ, gzipped or not, told apart by the first character."""
    with open_text(path) as f:
        first = f.read(1)
    if first == "@":
        return read_fastq(path)
    return read_fasta(path)
