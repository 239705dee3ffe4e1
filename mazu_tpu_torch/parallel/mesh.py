"""The (data, bucket) mesh that the sharded queries run on.

The reference lays a ``jax.sharding.Mesh`` with axes ``data`` and
``bucket`` over its chips and runs each builder's per-shard function under
``shard_map``. Here a builder writes that function once,
``fn(rank, shared, local, kms)``, where ``rank`` is a ``Rank``: it knows
its ``data_rank`` and ``bucket_rank`` (and the mesh's ``n_data`` and
``n_bucket``) and offers the two collectives over its bucket row:

- ``psum_bucket(t)``: the sum over the row, exact for the one-hot merges
  (int64 bit patterns wrap as the reference's u64 bit-cast does; ``bool``
  and ``uint8`` are summed as int32, a bool result is "any");
- ``all_to_all_bucket(t)``: ``t`` holds one block a destination on its
  leading axis; the result holds one block a source.

Two meshes run the function:

- ``DistMesh``: one process a rank over ``torch.distributed`` (NCCL on
  GPUs, gloo on the CPU), with a process group for each bucket row and for
  each data column. The process group must be up already, with world size
  ``n_data * n_bucket``: nothing here starts it or stands in for it.
- ``SerialMesh``: every rank in one process on one device, in turn: rank
  (0, 0) runs to its first collective, then (0, 1), and so on; the last
  one completes every row's collective and (0, 0) goes on. Each shard's
  arrays stay on the device at once, so it shows the memory split but not
  a gain in time. It runs only where a caller names it.

``Mesh.query`` splits a global batch over the data axis (or over every
rank, for the all-to-all query), runs the function on the ranks this
process holds and returns the global result: the data shards' outputs
concatenated, as the reference's ``out_specs=P(data)`` does.
"""

from __future__ import annotations

import threading
import time

import torch

def _widen(t: torch.Tensor):
    if t.dtype == torch.bool:
        return t.to(torch.int32), "any"
    if t.dtype == torch.uint8:
        return t.to(torch.int32), torch.uint8
    return t, None


def _narrow(t: torch.Tensor, how):
    if how == "any":
        return t > 0
    if how is not None:
        return t.to(how)
    return t


def _split(kms: torch.Tensor, n: int) -> list:
    if kms.shape[0] % n:
        raise ValueError(f"batch of {kms.shape[0]} does not split into {n} equal shards")
    return list(torch.chunk(kms, n)) if n > 1 else [kms]


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _build(pairs) -> dict:
    root: dict = {}
    for path, v in pairs:
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return root


def concat_trees(trees: list) -> dict:
    """Leaf-wise concatenation of equal-shaped output dicts (0-d leaves
    become one entry each)."""
    flat = [dict(_flatten(t)) for t in trees]
    return _build((path, torch.cat([f[path] if f[path].dim() else f[path][None]
                                    for f in flat]))
                  for path in flat[0])


class Rank:
    """One rank's view of the mesh, handed to a builder's shard function."""

    def __init__(self, mesh, data_rank: int, bucket_rank: int):
        self.mesh = mesh
        self.data_rank = data_rank
        self.bucket_rank = bucket_rank
        self.n_data = mesh.n_data
        self.n_bucket = mesh.n_bucket

    def psum_bucket(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh._collective(self, "psum", t)

    def all_to_all_bucket(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] != self.n_bucket:
            raise ValueError(f"all_to_all_bucket needs {self.n_bucket} blocks, got {t.shape[0]}")
        return self.mesh._collective(self, "a2a", t)


class Mesh:
    n_data: int
    n_bucket: int
    device: torch.device

    def local_buckets(self) -> list:
        """The bucket ranks whose shards this process holds."""
        raise NotImplementedError

    def query(self, fn, shared: dict, stacked: dict, kms: torch.Tensor,
              split: str = "data") -> dict:
        """``fn(rank, shared, stacked[bucket_rank], local kms)`` on this
        process's ranks; the global result. ``split="data"``: each data row
        takes a contiguous 1/``n_data`` of ``kms`` and its bucket ranks
        agree (their outputs went through ``psum_bucket``); ``"rank"``:
        rank (d, b) takes slice ``d * n_bucket + b``."""
        raise NotImplementedError


class SerialMesh(Mesh):
    """Every rank in this process, in turn, on ``device``. ``seconds[(d,
    b)]`` sums each rank's run time between collectives (the device
    synchronized at each step when it is a GPU), over all queries since
    ``reset_seconds``."""

    def __init__(self, n_data: int = 1, n_bucket: int = 1, device="cpu"):
        self.n_data, self.n_bucket = int(n_data), int(n_bucket)
        self.device = torch.device(device)
        self.seconds = {}
        self.reset_seconds()

    def reset_seconds(self) -> None:
        self.seconds = {(d, b): 0.0 for d in range(self.n_data) for b in range(self.n_bucket)}

    def local_buckets(self) -> list:
        return list(range(self.n_bucket))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def query(self, fn, shared, stacked, kms, split="data"):
        nd, nb = self.n_data, self.n_bucket
        ranks = [Rank(self, d, b) for d in range(nd) for b in range(nb)]
        parts = _split(kms, nd if split == "data" else nd * nb)
        n = len(ranks)
        cond = threading.Condition()
        st = {"turn": 0, "slots": [None] * n, "results": [None] * n, "done": [False] * n,
              "error": None, "t0": 0.0}
        self._st, self._cond = st, cond

        def pass_turn(i):
            # caller holds cond; the last live rank of a round completes it
            nxt = next((j for j in range(i + 1, n) if not st["done"][j]), None)
            if nxt is None:
                self._complete_round()
                nxt = next((j for j in range(n) if not st["done"][j]), None)
            if nxt is None:
                st["turn"] = None
            else:
                st["turn"] = nxt
                st["t0"] = time.perf_counter()
            cond.notify_all()

        def worker(i):
            r = ranks[i]
            with cond:
                cond.wait_for(lambda: st["turn"] == i or st["error"] is not None)
                if st["error"] is not None:
                    return
            try:
                local = parts[r.data_rank if split == "data" else i]
                st["results"][i] = fn(r, shared, stacked[r.bucket_rank], local)
                self._sync()
            except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                with cond:
                    st["error"] = st["error"] or e
                    cond.notify_all()
                return
            with cond:
                self.seconds[(r.data_rank, r.bucket_rank)] += time.perf_counter() - st["t0"]
                st["done"][i] = True
                pass_turn(i)

        self._ranks = ranks
        self._pass_turn = pass_turn
        threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n)]
        st["t0"] = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if st["error"] is not None:
            raise st["error"]
        res = st["results"]
        if split == "data":
            return concat_trees([res[d * nb] for d in range(nd)])
        return concat_trees(res)

    def _collective(self, rank, kind, t):
        st, cond = self._st, self._cond
        i = rank.data_rank * self.n_bucket + rank.bucket_rank
        self._sync()
        with cond:
            self.seconds[(rank.data_rank, rank.bucket_rank)] += time.perf_counter() - st["t0"]
            st["slots"][i] = (kind, t)
            self._pass_turn(i)
            cond.wait_for(lambda: st["turn"] == i or st["error"] is not None)
            if st["error"] is not None:
                raise RuntimeError("another rank failed")
            out = st["slots"][i]
            st["slots"][i] = None
            return out

    def _complete_round(self):
        """Every waiting rank's collective, row by row (caller holds the
        condition). A rank that finished while its row waits is a
        mismatch."""
        st = self._st
        nb = self.n_bucket
        for d in range(self.n_data):
            row = [st["slots"][d * nb + b] for b in range(nb)]
            if all(s is None for s in row):
                continue
            if any(s is None for s in row) or len({s[0] for s in row}) != 1:
                st["error"] = RuntimeError(f"data row {d}: its ranks reached different "
                                           "collectives")
                return
            kind = row[0][0]
            vals = [s[1] for s in row]
            if kind == "psum":
                w = [_widen(v) for v in vals]
                total = w[0][0].clone()
                for v, _ in w[1:]:
                    total += v
                out = [_narrow(total, w[0][1])] * nb
            else:
                out = [torch.stack([vals[s][b] for s in range(nb)]) for b in range(nb)]
            for b in range(nb):
                st["slots"][d * nb + b] = out[b]


class DistMesh(Mesh):
    """This process's rank of an ``n_data x n_bucket`` mesh over the
    running ``torch.distributed`` group: rank r is (r // n_bucket, r %
    n_bucket). Its tensors live on ``device`` (by default the card
    ``cuda:<local rank>`` under NCCL, the CPU under gloo)."""

    def __init__(self, n_data: int, n_bucket: int, device=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        self.n_data, self.n_bucket = int(n_data), int(n_bucket)
        world, rank = dist.get_world_size(), dist.get_rank()
        if world != self.n_data * self.n_bucket:
            raise ValueError(f"world size {world} is not {n_data} x {n_bucket}")
        backend = dist.get_backend()
        if device is None:
            device = (f"cuda:{rank % max(torch.cuda.device_count(), 1)}"
                      if backend == "nccl" else "cpu")
        self.device = torch.device(device)
        self.rank = Rank(self, rank // self.n_bucket, rank % self.n_bucket)
        nb = self.n_bucket
        self._row = self._col = None
        # every rank creates every group, in the same order
        for d in range(self.n_data):
            g = dist.new_group([d * nb + b for b in range(nb)])
            if d == self.rank.data_rank:
                self._row = g
        for b in range(nb):
            g = dist.new_group([d * nb + b for d in range(self.n_data)])
            if b == self.rank.bucket_rank:
                self._col = g
        self._world = dist.group.WORLD

    def local_buckets(self) -> list:
        return [self.rank.bucket_rank]

    def _collective(self, rank, kind, t):
        import torch.distributed as dist

        if kind == "psum":
            v, how = _widen(t)
            v = v.contiguous().clone()
            dist.all_reduce(v, group=self._row)
            return _narrow(v, how)
        v, how = _widen(t)
        v = v.contiguous()
        out = torch.empty_like(v)
        dist.all_to_all_single(out, v, group=self._row)
        return _narrow(out, how)

    def _gather(self, out: dict, group, n: int) -> dict:
        import torch.distributed as dist

        if n == 1:
            return concat_trees([out])
        pairs = []
        for path, t in _flatten(out):
            v, how = _widen(t)
            v = v.contiguous()
            parts = [torch.empty_like(v) for _ in range(n)]
            dist.all_gather(parts, v, group=group)
            pairs.append((path, [_narrow(p, how) for p in parts]))
        return concat_trees([_build((path, ps[i]) for path, ps in pairs) for i in range(n)])

    def query(self, fn, shared, stacked, kms, split="data"):
        r = self.rank
        if split == "data":
            local = _split(kms, self.n_data)[r.data_rank]
            out = fn(r, shared, stacked[r.bucket_rank], local)
            return self._gather(out, self._col, self.n_data)
        local = _split(kms, self.n_data * self.n_bucket)[r.data_rank * self.n_bucket
                                                         + r.bucket_rank]
        out = fn(r, shared, stacked[r.bucket_rank], local)
        return self._gather(out, self._world, self.n_data * self.n_bucket)
