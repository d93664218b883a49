"""Rank groups: the port's (dp, pp, ep, sp, tp) mesh over torch.distributed.

The JAX package's make_mesh lays devices out as (dp, pp, ep, sp, tp) for
one controller. Here each rank is a process, and a Mesh(tp, dp, ep=, sp=,
pp=) is the process groups that one model's collectives run in, over the
first tp * sp * ep * pp * dp ranks of the world (ranks past them hold
nothing of it), laid out as JAX's, tp minor:

  rank = (((dp_rank * pp + pp_rank) * ep + ep_rank) * sp + sp_rank) * tp
         + tp_rank

and a dp block is the pp * ep * sp * tp ranks of one dp_rank.

  - the tp ranks that share every other coordinate form a tp group: the
    forward's all_reduces (models/llama.py) run there;
  - with ep > 1, the ep ranks of one (dp block, tp rank) form an ep
    group: each holds E / ep experts of every MoE layer (and the same
    attention heads and cache: attention is replicated over ep, as JAX's
    kv_specs has it), and an expert FFN's output is all_reduced there
    before the tp all_reduce;
  - with sp > 1, the sp ranks form an sp group: each holds max_seq / sp
    positions of the dense cache (rank sp_rank the positions from
    sp_rank * max_seq / sp), the same weights, and each layer's
    attention merges their softmax states there (ops/attention.py
    gqa_attention_quant_sp: one max and two sums);
  - with pp > 1, the pp ranks form a pp group of stages: stage s holds
    layers [s * L / pp, (s + 1) * L / pp) and their cache, and hands its
    residual to stage s + 1 (send / recv; parallel/pp.py);
  - the ranks holding the same shards in every block form a peer group:
    a prefix-cache snapshot saved in one block is copied to the others;
  - all ranks of the mesh form the mesh group: the blocks' rows of a
    forward's output are put together there.

new_group is collective over the world, so every rank builds every
group, in the same order: a Mesh is built by an operation every rank
applies (parallel/tp.py).

TPComm runs a group's collectives on any device: over gloo a CUDA
tensor goes through a host copy (gloo stages through the host anyway),
over NCCL in place. all_reduce and broadcast serve tp, ep, sp and dp;
send and recv (the stage hand-off) move a tensor's bytes, so any dtype
crosses gloo.

The KV layout (the JAX kv_specs): kv heads over tp, slots over dp, the
dense cache's time axis over sp, layers over pp; the paged pool's pages
over dp, each block's slots granted only its own pages (kv/paged.py
PagePool(n_groups=dp)), its layers over pp (the page table replicated,
as JAX's pp_kv_specs has it).
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

    def send(self, t: torch.Tensor, dst: int) -> None:
        """t's bytes to group rank `dst` (which calls recv)."""
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if self.stage and b.device.type != "cpu":
            b = b.cpu()
        dist.send(b, dist.get_global_rank(self.group, dst), group=self.group)

    def recv(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """t's bytes from group rank `src`, in place; returns t."""
        b = t.view(-1).view(torch.uint8)
        c = b.cpu() if self.stage and b.device.type != "cpu" else b
        dist.recv(c, dist.get_global_rank(self.group, src), group=self.group)
        if c is not b:
            b.copy_(c)
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


AXES = ("dp", "pp", "ep", "sp", "tp")  # major to minor


class Mesh:
    """The (dp, pp, ep, sp, tp) groups of one model, from the view of
    world rank `rank`. Built on every rank of the world in the same
    order."""

    def __init__(self, tp: int, dp: int, rank: int, world: int,
                 backend: str, ep: int = 1, sp: int = 1, pp: int = 1):
        sizes = dict(dp=dp, pp=pp, ep=ep, sp=sp, tp=tp)
        if min(sizes.values()) < 1 or tp * sp * ep * pp * dp > world:
            raise ValueError(f"a mesh of tp={tp} x sp={sp} x ep={ep} x "
                             f"pp={pp} x dp={dp} on {world} ranks")
        self.tp, self.dp, self.ep, self.sp, self.pp = tp, dp, ep, sp, pp
        self.rank = rank
        self.size = tp * sp * ep * pp * dp
        self.member = rank < self.size
        coord, r = {}, rank
        for axis in reversed(AXES):
            coord[axis], r = r % sizes[axis], r // sizes[axis]
        self.tp_rank, self.sp_rank, self.ep_rank = (coord["tp"], coord["sp"],
                                                    coord["ep"])
        self.pp_rank, self.dp_rank = coord["pp"], coord["dp"]

        def ravel(c: dict) -> int:
            out = 0
            for axis in AXES:
                out = out * sizes[axis] + c[axis]
            return out

        def groups(axis: str):
            """This rank's group along `axis`: one group for every setting
            of the other coordinates, in their order."""
            others = [a for a in AXES if a != axis]
            mine = None
            for i in range(self.size // sizes[axis]):
                c, rest = {}, i
                for a in reversed(others):
                    c[a], rest = rest % sizes[a], rest // sizes[a]
                ranks = [ravel({**c, axis: j}) for j in range(sizes[axis])]
                grp = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    mine = grp
            return mine

        mine = {"tp": groups("tp")}
        for axis in ("ep", "sp", "pp"):
            if sizes[axis] > 1:
                mine[axis] = groups(axis)
        mine["peer"] = groups("dp")
        grp = dist.new_group(list(range(self.size)), backend=backend)
        mine["mesh"] = grp if self.member else None
        self.comm = self.ep_comm = self.sp_comm = self.pp_comm = None
        self.peers = self.all = None
        if self.member:
            self.comm = TPComm(mine["tp"], self.tp_rank, tp, backend)
            if ep > 1:
                self.ep_comm = TPComm(mine["ep"], self.ep_rank, ep, backend)
            if sp > 1:
                self.sp_comm = TPComm(mine["sp"], self.sp_rank, sp, backend)
            if pp > 1:
                self.pp_comm = TPComm(mine["pp"], self.pp_rank, pp, backend)
            self.peers = TPComm(mine["peer"], self.dp_rank, dp, backend)
            self.all = TPComm(mine["mesh"], rank, self.size, backend)

    @property
    def lead(self) -> bool:
        """The one rank of its dp block whose rows stand for the block's
        (every coordinate but dp at 0)."""
        return not (self.tp_rank or self.ep_rank or self.sp_rank
                    or self.pp_rank)

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
        if self.lead:
            full[lo:hi] = local
        return self.all.all_reduce(full).to(dtype)
