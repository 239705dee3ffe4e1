"""Command-line interface (counterpart of ``mazu_tpu.cli``): the same
subcommands, defaults, exit codes and printed lines, with the queries on
the card.

  mazu-tpu-torch index build piscem     -p <cf_prefix> -o out.npz [-m W] [-s SKEW] [--engine E]
  mazu-tpu-torch index build pufferfish -p <cf_prefix> -o out.npz
  mazu-tpu-torch index stats          -i out.npz
  mazu-tpu-torch index validate-fasta -i out.npz -f refs.fa [--streaming]
  mazu-tpu-torch index map            -i out.npz -f reads.(fa|fastq)[.gz]
  mazu-tpu-torch index colors         -i out.npz [-o colors.npz]
  mazu-tpu-torch index pseudomap      -i out.npz -f reads.(fa|fastq)[.gz] [--policy P] [--tau T] [--list]
  mazu-tpu-torch kphf build (sshash|pfhash|sampled|cuckoo|mono|mono2) -p <cf_prefix> -o out.npz [--validate]
  mazu-tpu-torch kphf validate -i kphf.npz
  mazu-tpu-torch kphf stats    -i kphf.npz
  mazu-tpu-torch kphf bench    -i kphf.npz -f queries.fa [--streaming] [--device]

Run it as ``python -m mazu_tpu_torch.cli``. Index arguments also accept a
pufferfish index directory (dense or sparse, told apart by its
``info.json``). Checkpoints are ``io.checkpoint``'s ``.npz`` files, which
``mazu_tpu`` writes and reads too.

``--torch-device`` (default ``cuda``) is where builds and queries run;
without a card the CLI exits with ``convert.resolve_device``'s error
unless it is given ``cpu``.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np

log = logging.getLogger("mazu_tpu_torch")

DEFAULT_SKEW = 64
DEFAULT_W = 15


def _build_parser():
    p = argparse.ArgumentParser(prog="mazu-tpu-torch")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--torch-device", default="cuda",
                   help="torch device of the builds and queries (default: cuda)")
    sub = p.add_subparsers(dest="tool", required=True)

    idx = sub.add_parser("index").add_subparsers(dest="cmd", required=True)
    bsub = idx.add_parser("build").add_subparsers(dest="flavor", required=True)
    for flavor in ("piscem", "pufferfish"):
        f = bsub.add_parser(flavor)
        f.add_argument("-p", "--cf-prefix", required=True)
        f.add_argument("-o", "--output", required=True)
        if flavor == "piscem":
            f.add_argument("-m", "--minimizer-size", type=int, default=DEFAULT_W)
            f.add_argument("-s", "--skew-param", type=int, default=DEFAULT_SKEW)
            f.add_argument("--engine",
                           choices=["parity", "fast32", "direct", "cuckoo", "mono", "mono2"],
                           default="parity", help="K2U engine")
    st = idx.add_parser("stats", help="size accounting down the index stack")
    st.add_argument("-i", "--index", required=True)
    v = idx.add_parser("validate-fasta")
    v.add_argument("-i", "--index", required=True)
    v.add_argument("-f", "--fasta", required=True)
    v.add_argument("--streaming", action="store_true")
    mp = idx.add_parser("map")
    mp.add_argument("-i", "--index", required=True)
    mp.add_argument("-f", "--fasta", required=True, help="reads (FASTA/FASTQ, optionally .gz)")
    cc = idx.add_parser("colors", help="build the color-class layer (unitig -> ref-id set)")
    cc.add_argument("-i", "--index", required=True)
    cc.add_argument("-o", "--output", help="save color classes to .npz")
    pm = idx.add_parser("pseudomap", help="pseudo-align reads against the color classes")
    pm.add_argument("-i", "--index", required=True)
    pm.add_argument("-f", "--fasta", required=True, help="reads (FASTA/FASTQ, optionally .gz)")
    pm.add_argument("--list", action="store_true", help="print per-read candidate refs")
    pm.add_argument("--policy", choices=["intersect", "union", "threshold"], default="intersect")
    pm.add_argument("--tau", type=float, default=0.7, help="threshold-policy coverage fraction")

    kp = sub.add_parser("kphf").add_subparsers(dest="cmd", required=True)
    bsub = kp.add_parser("build").add_subparsers(dest="flavor", required=True)
    for flavor in ("sshash", "pfhash", "sampled", "cuckoo", "mono", "mono2"):
        f = bsub.add_parser(flavor)
        f.add_argument("-p", "--cf-prefix", required=True)
        f.add_argument("-o", "--output", required=True)
        f.add_argument("--validate", action="store_true")
        if flavor == "sampled":
            f.add_argument("--sample-size", type=int, default=9)
            f.add_argument("--extension-size", type=int, default=4)
        if flavor == "sshash":
            f.add_argument("-m", "--minimizer-size", type=int, default=DEFAULT_W)
            f.add_argument("-s", "--skew-param", type=int, default=DEFAULT_SKEW)
            f.add_argument("--engine", choices=["parity", "fast32", "direct", "cuckoo"],
                           default="parity")
    for cmd in ("validate", "stats"):
        kp.add_parser(cmd).add_argument("-i", "--input", required=True)
    c = kp.add_parser("bench")
    c.add_argument("-i", "--input", required=True)
    c.add_argument("-f", "--fasta", required=True)
    c.add_argument("--streaming", action="store_true")
    c.add_argument("--device", action="store_true",
                   help="time the batched query as one call on the torch device, first call "
                        "and warm call apart")
    return p


def _load_index_arg(path: str):
    """An ``.npz`` checkpoint, or a pufferfish index directory (dense or
    sparse, from its ``info.json``)."""
    import json
    import os

    from .err import IndexLoad

    if os.path.isdir(path):
        from .io.pf1_index import load_dense_index, load_sparse_index

        info = os.path.join(path, "info.json")
        if not os.path.exists(info):
            raise IndexLoad(f"{path}: directory without info.json (not a pf1 index)")
        with open(info) as f:
            sampling = json.load(f).get("sampling_type", "dense")
        return (load_sparse_index if sampling == "sparse" else load_dense_index)(path)
    if not os.path.exists(path):
        raise IndexLoad(f"{path}: no such file")
    from .io.checkpoint import load_index

    return load_index(path)


class _Timer:
    """Seconds of a span of work on ``dev``: CUDA events on the card (the
    device's own clock), the host clock on the CPU."""

    def __init__(self, dev):
        import torch

        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.start, self.end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def seconds(self) -> float:
        if not self.cuda:
            return time.perf_counter() - self.t0
        self.end.record()
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def main(argv=None):
    from .err import MazuError

    try:
        return _main(argv)
    except (MazuError, FileNotFoundError, IsADirectoryError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None):
    args = _build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    from .convert import resolve_device

    try:
        dev = resolve_device(args.torch_device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.tool == "index":
        _index(args, dev)
    else:
        _kphf(args, dev)
    return 0


def _index(args, dev) -> None:
    from .io.checkpoint import save_index

    if args.cmd == "build":
        from .index.piscem_index import (
            piscem_index_from_cf_prefix, pufferfish_dense_index_from_cf_prefix,
        )

        t = time.time()
        if args.flavor == "piscem":
            sp = None if args.skew_param <= 0 else args.skew_param
            idx = piscem_index_from_cf_prefix(args.cf_prefix, w=args.minimizer_size,
                                              skew_param=sp, engine=args.engine, device=dev)
        else:
            idx = pufferfish_dense_index_from_cf_prefix(args.cf_prefix, device=dev)
        log.info("built in %.1fs", time.time() - t)
        save_index(idx, args.output)
        print(f"wrote {args.output}")
    elif args.cmd == "stats":
        idx = _load_index_arg(args.index)
        n_k = max(1, idx.n_kmers)
        print(f"index_type: {idx.index_type}   k: {idx.k}")
        print(f"n_kmers: {idx.n_kmers}  n_unitigs: {idx.n_unitigs}  n_refs: {idx.n_refs}")
        k2u_bits = idx.k2u.num_bits()
        u2_bits = idx.u2pos.num_bits()
        print(f"k2u:   {k2u_bits/8e6:10.2f} MB  ({k2u_bits/n_k:6.2f} bits/kmer)")
        print(f"u2pos: {u2_bits/8e6:10.2f} MB  ({u2_bits/n_k:6.2f} bits/kmer)")
        if hasattr(idx.k2u, "print_stats"):
            idx.k2u.print_stats()
    elif args.cmd == "validate-fasta":
        idx = _load_index_arg(args.index)
        if args.streaming:
            from .index.streaming import validate_fasta_streaming

            validate_fasta_streaming(idx, args.fasta, device=dev)
        else:
            from .index.validate import validate_fasta

            validate_fasta(idx, args.fasta, device=dev)
        print("valid")
    elif args.cmd == "colors":
        idx = _load_index_arg(args.index)
        t = time.time()
        cc = idx.color_classes()
        log.info("built in %.1fs", time.time() - t)
        cc.print_stats()
        if args.output:
            cc.save(args.output)
            print(f"wrote {args.output}")
    elif args.cmd == "pseudomap":
        from .index.pseudoalign import PseudoAligner

        idx = _load_index_arg(args.index)
        pa = PseudoAligner(idx, policy=args.policy, tau=args.tau, device=dev)
        t = time.time()
        results = pa.map_file(args.fasta)
        dt = time.time() - t
        names = idx.ref_names
        mapped = sum(1 for r, h, _ in results if h and len(r))
        n_k = sum(nk for _, _, nk in results)
        print(f"{len(results)} reads, {mapped} mapped "
              f"({idx.n_refs} refs, {pa.cc.n_classes} color classes)")
        print(f"{dt:.3f}s total, {dt / max(n_k, 1) * 1e9:.1f} ns/kmer")
        if args.list:
            for i, (r, h, nk) in enumerate(results):
                labels = [names[j] if j < len(names) else str(j) for j in r.tolist()]
                print(f"read {i}: {h}/{nk} k-mers hit -> {','.join(labels)}")
    elif args.cmd == "map":
        from .index.mapping import ReadMapper

        idx = _load_index_arg(args.index)
        mapper = ReadMapper(idx, device=dev)
        t = time.time()
        results = mapper.map_file(args.fasta)
        dt = time.time() - t
        n_kmers = sum(r.n_kmers for r in results)
        n_hit = sum(r.n_hit for r in results)
        print(f"{len(results)} reads, {n_kmers} k-mers, {n_hit} hits")
        print(f"{dt:.3f}s total, {dt / max(n_kmers, 1) * 1e9:.1f} ns/kmer")


def _build_k2u(args, dev):
    from .containers.unitig_set import UnitigSet
    from .io.cuttlefish import CfFiles

    us, _ = UnitigSet.from_cf(CfFiles(args.cf_prefix))
    if args.flavor == "sshash":
        from .kphf.sshash import SSHash

        sp = None if args.skew_param <= 0 else args.skew_param
        # the reference's SSHash builds its parity engine under any name
        # but fast32 and direct, "cuckoo" too
        engine = "parity" if args.engine == "cuckoo" else args.engine
        return SSHash.from_unitig_set(us, args.minimizer_size, skew_param=sp, engine=engine,
                                      device=dev)
    if args.flavor == "sampled":
        from .kphf.sampled import SampledPFHash

        return SampledPFHash.from_unitig_set(us, sample_size=args.sample_size,
                                             extension_size=args.extension_size, device=dev)
    if args.flavor == "cuckoo":
        from .kphf.kcdict import KCDict

        return KCDict.from_unitig_set(us)
    if args.flavor in ("mono", "mono2"):
        from .kphf.kcdict import KCDict

        return KCDict.from_unitig_set(us, load=0.125, scheme=args.flavor)
    from .kphf.pfhash import PFHash

    return PFHash.from_unitig_set(us, device=dev)


def _kphf(args, dev) -> None:
    from .io.checkpoint import load_k2u, save_k2u

    if args.cmd == "build":
        t = time.time()
        k2u = _build_k2u(args, dev)
        log.info("built in %.1fs", time.time() - t)
        if args.validate:
            from .index.validate import validate_k2u_self

            t = time.time()
            validate_k2u_self(k2u, device=dev)
            dt = time.time() - t
            n = 2 * k2u.n_kmers
            print(f"validated {n} queries in {dt:.2f}s ({dt / n * 1e9:.1f} ns/kmer)")
        save_k2u(k2u, args.output)
        print(f"wrote {args.output}")
    elif args.cmd == "validate":
        from .index.validate import validate_k2u_self

        validate_k2u_self(load_k2u(args.input), device=dev)
        print("valid")
    elif args.cmd == "stats":
        k2u = load_k2u(args.input)
        print(f"n_kmers: {k2u.n_kmers}")
        print(f"k: {k2u.k}")
        print(f"n_unitigs: {k2u.unitigs.n_unitigs}")
        if hasattr(k2u, "print_stats"):
            k2u.print_stats()
    elif args.cmd == "bench":
        mt, dt = _bench(load_k2u(args.input), args, dev)
        hits = int((mt > 0).sum())
        n = len(mt)
        print(f"{n} queries, {hits} hits, {n - hits} misses")
        print(f"{dt:.3f}s total, {dt / max(n, 1) * 1e9:.1f} ns/kmer")


def _bench(k2u, args, dev):
    """(match types of the queries, seconds of the timed call): the FASTA's
    k-mers through the streaming query (``--streaming``: the cache's flat
    pass with ``--device``, else its host loop) or the batched K2U query
    (``--device``: padded to 8192 lanes, a first call, then the timed
    warm call)."""
    import torch

    from .io.fasta import read_fasta

    if args.streaming:
        from .index.streaming import StreamingIndex, kmerize_reads

        si = StreamingIndex(k2u, mode="flat" if args.device else "host", device=dev)
        kms, valid, _ = kmerize_reads([seq for _, seq in read_fasta(args.fasta)], k2u.k)
        if args.device:
            t = time.time()
            si.k2u_reads(kms, valid)
            print(f"compile+first: {time.time() - t:.2f}s")
        timer = _Timer(dev)
        r = si.k2u_reads(kms, valid)
        return np.asarray(r["mt"])[valid], timer.seconds()
    from .convert import arrays_from_numpy, words_to
    from .index.modindex import k2u_batch
    from .index.validate import valid_kmer_windows

    words = np.concatenate([valid_kmer_windows(seq, k2u.k)[1]
                            for _, seq in read_fasta(args.fasta)])
    d = {"k2u": arrays_from_numpy(k2u.device_arrays(), dev)}
    if args.device:
        pad = (-len(words)) % 8192
        fw = words_to(np.concatenate([words, np.zeros(pad, dtype=np.uint64)]), dev)
        t = time.time()
        k2u_batch(d, fw)["mt"].cpu()
        print(f"compile+first: {time.time() - t:.2f}s")
    else:
        fw = words_to(words, dev)
    timer = _Timer(dev)
    r = k2u_batch(d, fw)
    dt = timer.seconds()
    return r["mt"][: len(words)].cpu().numpy(), dt


if __name__ == "__main__":
    sys.exit(main())
