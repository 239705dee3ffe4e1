"""The control of a cell: the reference put in the program's place with one
guarantee of the configuration broken, checked as a run checks the
program. It must come out not correct.

The guarantee broken is "every occurrence": the control answers each
k-mer with at most the first two occurrences of its unitig, the width of
the main phase's projection, as a program that dropped its compacted
second phase would. Most exons of a gene with several transcripts lie on
more than two of them.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

From the root of a checkout, on the card, at the cell's own size. Prints,
for each seed, the wrong batches of the control's results out of the
pool's, and exits 1 if any seed's control comes out correct
(``portbench/tests`` runs it on the host at a small size).
"""

from __future__ import annotations

import argparse
import importlib
import sys
import time
from pathlib import Path

import torch

MAX_OCCS = 2


def representative(right):
    """One result out of a batch's right results (a set of sums, or per
    chunk a set of (map, pseudoalignment) pairs)."""
    if isinstance(right, set):
        return min(right)
    pairs = [min(s) for s in right]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


def control_wrong(spec: dict, seed: int, device) -> tuple:
    """(wrong batches, batches) of the control on every batch of the
    cell's pool for ``seed``."""
    from portbench import genome as genome_mod

    genome = genome_mod.make(spec["config"], seed, device)
    kind = importlib.import_module(f"portbench.traffic.{spec['mix']['kind']}")
    traffic = kind.Traffic(spec, genome, seed, device)
    genome.drop_device_copies()
    ids = list(range(len(traffic)))
    right = traffic.expected(ids)
    ctrl = traffic.expected(ids, max_occs=MAX_OCCS)
    wrong = sum(not traffic.matches(representative(ctrl[i]), right[i]) for i in ids)
    return wrong, len(ids)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from portbench.harness import cell_spec

    spec = cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    ok = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        wrong, n = control_wrong(spec, seed, torch.device("cuda", 0))
        ok &= wrong > 0
        print(f"control {args.workload} seed {seed}: {wrong} of {n} batches wrong "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
