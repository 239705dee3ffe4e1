"""The benchmark's sequence set, made from the seed: its unitigs, its
references and the occurrences that tile one by the other.

A configuration names its kind of sequence set (``"genome"``); the module
``portbench/genomes/<kind>.py`` makes it with ``make(cfg, seed, device)``.
This module holds what every kind shares: the ``Genome`` they return, the
seeded streams and the packing of base codes into words.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch


def streams(seed: int, n: int) -> list:
    """``n`` independent NumPy generators for one run's seed."""
    return [np.random.default_rng(s) for s in np.random.SeedSequence(int(seed)).spawn(n)]


def torch_generator(rng: np.random.Generator, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from a NumPy generator."""
    g = torch.Generator(device=device)
    g.manual_seed(int(rng.integers(0, 1 << 63)))
    return g


def random_words(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``n`` int64 words of 64 random bits (32 random bases each)."""
    lo = torch.randint(0, 1 << 32, (n,), generator=gen, device=device, dtype=torch.int64)
    hi = torch.randint(0, 1 << 32, (n,), generator=gen, device=device, dtype=torch.int64)
    return lo | (hi << 32)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Packed int64 words of 2-bit base codes, base i at bits [2i, 2i + 2)
    of word i // 32, with one zero guard word at the end."""
    n = codes.shape[0]
    c = torch.zeros(-(-n // 32) * 32 + 32, dtype=torch.int64, device=codes.device)
    c[:n] = codes.to(torch.int64)
    c = c.reshape(-1, 32)
    words = torch.zeros(c.shape[0], dtype=torch.int64, device=codes.device)
    for j in range(32):
        words |= c[:, j] << (2 * j)
    return words


@dataclass
class Genome:
    """The unitigs' packed bases (``words`` on the device, ``host_words``
    the same as u64 with the guard word) and bounds ``accum``; the
    references' packed bases (``ref_words``, ``ref_host_words``) and
    bounds ``ref_accum``; and the occurrence table, grouped by unitig
    (``offsets`` the bounds of each unitig's group): occurrence i lies on
    reference ``occ_ref[i]`` at ``occ_pos[i]``, forward where ``occ_o[i]``
    is 1."""

    k: int
    n_bases: int
    words: torch.Tensor
    host_words: np.ndarray
    accum: np.ndarray
    ref_words: torch.Tensor
    ref_host_words: np.ndarray
    ref_accum: np.ndarray
    occ_uid: np.ndarray
    occ_ref: np.ndarray
    occ_pos: np.ndarray
    occ_o: np.ndarray
    offsets: np.ndarray

    @property
    def n_unitigs(self) -> int:
        return len(self.accum) - 1

    @property
    def ref_lens(self) -> np.ndarray:
        return np.diff(self.ref_accum)

    @property
    def names(self) -> list:
        return [f"r{i}" for i in range(len(self.ref_accum) - 1)]

    def drop_device_copies(self) -> None:
        """Free the device's copies of the bases (the reference reads the
        host's)."""
        self.words = self.ref_words = None


def make(cfg: dict, seed: int, device) -> Genome:
    """The sequence set of a configuration for ``seed``, its bases on
    ``device``."""
    kind = importlib.import_module(f"portbench.genomes.{cfg['genome']}")
    return kind.make(cfg, seed, device)
