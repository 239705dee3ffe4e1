"""Start a ``torch.distributed`` world of N ranks and bring back what each
rank returns.

``launch(fn, world, *args)`` spawns ``world`` processes with
``torch.multiprocessing`` (start method spawn). Rank r joins the process
group through a ``file://`` rendezvous in a fresh temporary directory (so
parallel callers never race for a TCP port), runs ``fn(rank, world,
*args)``, and writes its result there with ``torch.save``; the parent
returns the results in rank order. ``fn`` must be importable by name from
a module that does not import the caller's test setup: the rank functions
of this package (``sharded_queries_rank``) are such functions. A rank that
fails, or an init that fails, raises in the parent: nothing carries on
unsharded.

``sharded_queries_rank`` builds a ``DistMesh`` and runs a list of sharded
query jobs (``sharding.BUILDERS`` by name), returning each job's output on
the CPU.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import traceback

import torch

TIMEOUT_S = 300


def _entry(rank, world, tmp, backend, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world: int, *args, backend: str = "gloo") -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process of a ``torch.distributed`` world over
    ``backend`` (gloo on the CPU, NCCL with a card a rank)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mazu_launch_") as tmp:
        try:
            mp.spawn(_entry, args=(world, tmp, backend, fn, args), nprocs=world, join=True)
        except Exception as e:
            errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                    if f.startswith("err_")]
            raise RuntimeError("a rank failed:\n" + "\n".join(errs)) from e
        return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
                for r in range(world)]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return tree


def sharded_queries_rank(rank: int, world: int, n_data: int, n_bucket: int,
                         jobs: list) -> dict:
    """One rank's run of ``jobs``: (name, builder, positional args, keyword
    args, k-mer words as a NumPy u64 array) each, ``builder`` a name in
    ``sharding.BUILDERS``, called with a ``DistMesh(n_data, n_bucket)``
    as its mesh argument. Returns {name: the query's output on the CPU},
    and ``"jax_loaded"``: whether anything imported jax in this process."""
    import sys

    from ..convert import words_to
    from .mesh import DistMesh
    from .sharding import BUILDERS

    mesh = DistMesh(n_data, n_bucket)
    out = {}
    for name, builder, bargs, kw, words in jobs:
        query = BUILDERS[builder](*bargs, mesh=mesh, **kw)
        if isinstance(query, tuple):  # make_data_parallel_query: (arrays, query)
            query = query[1]
        out[name] = _to_cpu(query(words_to(words, mesh.device)))
    out["jax_loaded"] = "jax" in sys.modules
    return out
