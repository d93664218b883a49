"""Token-tree construction for speculative decoding (host side): the
port's copy of the JAX package's speculative/tree.py.

The tree grows level by level: every frontier node of a depth level is
drafted in one batched forward, then children are admitted globally by
cumulative probability under the reference's knobs (draft_batch_size,
top_k, temperature, p_base, max_fan_out, min_prob). The flattened tree
becomes one target verification batch whose intra-batch attention mask
is the ancestor matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SpeculativeConfig:
    """Defaults mirror the reference (speculative_config.hpp:21-37)."""

    draft_batch_size: int = 12
    draft_top_k: int = 15
    draft_temperature: float = 1.5
    p_base: float = 0.9
    max_fan_out: int = 3
    min_prob: float = 0.2
    early_stop: bool = True
    # bound on the tree's depth: each level is one draft forward
    max_depth: int = 6


@dataclass
class TreeNode:
    token: int
    parent: int  # index into nodes, -1 for root
    depth: int  # 0 for root
    cum_prob: float


@dataclass
class TokenTree:
    """Flattened tree in construction (BFS-compatible) order; node 0 is
    the root (last accepted token)."""

    nodes: list[TreeNode] = field(default_factory=list)

    @property
    def size(self) -> int:
        return len(self.nodes)

    def add(self, token: int, parent: int, cum_prob: float) -> int:
        depth = 0 if parent < 0 else self.nodes[parent].depth + 1
        self.nodes.append(TreeNode(token, parent, depth, cum_prob))
        return len(self.nodes) - 1

    def tokens(self) -> np.ndarray:
        return np.asarray([n.token for n in self.nodes], np.int32)

    def depths(self) -> np.ndarray:
        return np.asarray([n.depth for n in self.nodes], np.int32)

    def ancestor_mask(self) -> np.ndarray:
        """[n, n] bool: node q may attend node j iff j is on q's root
        path (incl. itself) — the verification mask
        (token_tree.cpp:82-95)."""
        n = self.size
        m = np.zeros((n, n), bool)
        for q in range(n):
            j = q
            while j >= 0:
                m[q, j] = True
                j = self.nodes[j].parent
        return m

    def children_of(self, parent: int) -> list[int]:
        return [i for i, nd in enumerate(self.nodes) if nd.parent == parent]

    def accepted_chain(self, sampled: np.ndarray) -> tuple[list[int], list[int]]:
        """Walk the verification result (reference verify,
        token_tree.cpp:213-229).

        sampled: [n] target-greedy token at each node. Returns
        (accepted node indices after the root, emitted tokens). The walk
        starts at the root; at node u the target's sampled token t* is
        emitted, and generation continues from the child carrying t*."""
        accepted: list[int] = []
        emitted: list[int] = []
        u = 0
        while True:
            t_star = int(sampled[u])
            emitted.append(t_star)
            nxt = None
            for c in self.children_of(u):
                if self.nodes[c].token == t_star:
                    nxt = c
                    break
            if nxt is None:
                return accepted, emitted
            accepted.append(nxt)
            u = nxt


def grow_tree(
    root_token: int,
    cfg: SpeculativeConfig,
    draft_step,
) -> TokenTree:
    """Level-synchronous tree growth.

    draft_step(tokens [F], depths [F], tree, frontier_idx) ->
        (probs [F, k], ids [F, k]) — a batched draft forward over the
        current frontier (caller owns the draft KV bookkeeping).
    """
    tree = TokenTree()
    tree.add(root_token, -1, 1.0)
    frontier = [0]
    depth = 0
    while (tree.size < cfg.draft_batch_size and frontier
           and depth < cfg.max_depth):
        depth += 1
        toks = np.asarray([tree.nodes[i].token for i in frontier], np.int32)
        depths = np.asarray([tree.nodes[i].depth for i in frontier], np.int32)
        probs, ids = draft_step(toks, depths, tree, list(frontier))
        probs = np.asarray(probs, np.float64)
        ids = np.asarray(ids, np.int64)
        # candidate pool: (cum_prob, parent, token), globally ranked
        cands: list[tuple[float, int, int]] = []
        for fi, parent in enumerate(frontier):
            parent_cum = tree.nodes[parent].cum_prob
            top_p = float(probs[fi, 0])
            cum_mass = 0.0
            for j in range(min(cfg.max_fan_out, probs.shape[1])):
                p = float(probs[fi, j])
                if cum_mass >= cfg.p_base * top_p and j > 0:
                    break  # early fan-out cut once the head mass is covered
                cum = parent_cum * p
                if cfg.early_stop and cum < cfg.min_prob:
                    break  # candidates are sorted desc — rest are smaller
                cands.append((cum, parent, int(ids[fi, j])))
                cum_mass += p
        cands.sort(key=lambda c: -c[0])
        new_frontier: list[int] = []
        budget = cfg.draft_batch_size - tree.size
        for cum, parent, token in cands[:budget]:
            idx = tree.add(token, parent, cum)
            new_frontier.append(idx)
        frontier = new_frontier
    return tree
