"""Rank groups: the port's (dp, ep, tp) mesh over torch.distributed.

The JAX package's make_mesh lays devices out as (dp, pp, ep, sp, tp) for
one controller. Here each rank is a process, and a Mesh(tp, dp, ep=) is
the process groups that one model's collectives run in, over the first
tp * ep * dp ranks of the world (ranks past them hold nothing of it),
laid out as JAX's (dp, ep, tp):

  - rank r is tp rank r % tp of ep group (r // tp) % ep of dp block
    r // (tp * ep); a dp block is its ep * tp ranks;
  - the tp ranks of one (dp block, ep group) form a tp group: the
    forward's all_reduces (models/llama.py) run there;
  - with ep > 1, the ep ranks of one (dp block, tp rank) form an ep
    group: each holds E / ep experts of every MoE layer (and the same
    attention heads and cache: attention is replicated over ep, as JAX's
    kv_specs has it), and an expert FFN's output is all_reduced there
    before the tp all_reduce;
  - the ranks holding the same heads and experts in every block form a
    peer group: a prefix-cache snapshot saved in one block is copied to
    the others;
  - all ranks of the mesh form the mesh group: the blocks' rows of a
    forward's output are put together there.

new_group is collective over the world, so every rank builds every
group, in the same order: a Mesh is built by an operation every rank
applies (parallel/tp.py).

TPComm runs a group's collectives on any device: over gloo a CUDA
tensor is reduced through a host copy (gloo stages through the host
anyway), over NCCL in place. Only all_reduce and broadcast are used, the
two collectives gloo runs on CUDA tensors as well.

The KV layout (the JAX kv_specs): kv heads over tp, slots over dp; the
paged pool's pages over dp, each block's slots granted only its own
pages (kv/paged.py PagePool(n_groups=dp)).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class TPComm:
    """The collectives of one process group, seen from one of its ranks:
    `rank` of `size`."""

    def __init__(self, group, rank: int, size: int, backend: str):
        self.group, self.rank, self.size = group, rank, size
        self.stage = backend == "gloo"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """t reduced over the group, in place; returns t."""
        if self.size == 1:
            return t
        if self.stage and t.device.type != "cpu":
            c = t.cpu()
            dist.all_reduce(c, _OPS[op], group=self.group)
            return t.copy_(c)
        dist.all_reduce(t, _OPS[op], group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """t from group rank `src`, in place; returns t."""
        if self.size == 1:
            return t
        src = dist.get_global_rank(self.group, src)
        if self.stage and t.device.type != "cpu":
            c = t.cpu()
            dist.broadcast(c, src, group=self.group)
            return t.copy_(c)
        dist.broadcast(t, src, group=self.group)
        return t


class Mesh:
    """The (dp, ep, tp) groups of one model, from the view of world rank
    `rank`. Built on every rank of the world in the same order."""

    def __init__(self, tp: int, dp: int, rank: int, world: int,
                 backend: str, ep: int = 1):
        if tp < 1 or dp < 1 or ep < 1 or tp * ep * dp > world:
            raise ValueError(f"a mesh of tp={tp} x ep={ep} x dp={dp} on "
                             f"{world} ranks")
        self.tp, self.dp, self.ep, self.rank = tp, dp, ep, rank
        self.size = tp * ep * dp
        self.member = rank < self.size
        block = tp * ep
        self.tp_rank = rank % tp
        self.ep_rank = (rank // tp) % ep
        self.dp_rank = rank // block
        mine = {}
        for g in range(dp):
            for e in range(ep):
                ranks = [g * block + e * tp + t for t in range(tp)]
                grp = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    mine["tp"] = grp
        if ep > 1:
            for g in range(dp):
                for t in range(tp):
                    ranks = [g * block + e * tp + t for e in range(ep)]
                    grp = dist.new_group(ranks, backend=backend)
                    if rank in ranks:
                        mine["ep"] = grp
        for e in range(ep):
            for t in range(tp):
                ranks = [g * block + e * tp + t for g in range(dp)]
                grp = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    mine["peer"] = grp
        grp = dist.new_group(list(range(self.size)), backend=backend)
        mine["mesh"] = grp if self.member else None
        self.comm = self.ep_comm = self.peers = self.all = None
        if self.member:
            self.comm = TPComm(mine["tp"], self.tp_rank, tp, backend)
            if ep > 1:
                self.ep_comm = TPComm(mine["ep"], self.ep_rank, ep, backend)
            self.peers = TPComm(mine["peer"], self.dp_rank, dp, backend)
            self.all = TPComm(mine["mesh"], rank, self.size, backend)

    def block(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's dp block of n slots (or pages)."""
        if n % self.dp:
            raise ValueError(f"{n} slots or pages do not split into "
                             f"{self.dp} dp blocks")
        b = n // self.dp
        return self.dp_rank * b, (self.dp_rank + 1) * b

    def assemble(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The [n, ...] tensor whose dp blocks of rows the blocks hold
        (each block's `local`, equal on its ranks), on every rank."""
        if self.dp == 1:
            return local
        lo, hi = self.block(n)
        dtype = local.dtype
        wide = torch.int32 if dtype == torch.bool else dtype
        full = torch.zeros((n,) + tuple(local.shape[1:]), dtype=wide,
                           device=local.device)
        if self.tp_rank == 0 and self.ep_rank == 0:
            full[lo:hi] = local
        return self.all.all_reduce(full).to(dtype)
