"""Host-side radix-trie prefix cache — KV reuse at admission. The port
of `repro/launch/prefix_cache.py`: the trie, LRU and byte-budget logic
are the reference's line for line; the snapshots are CPU torch tensors.

Production long-context traffic is dominated by shared prompt prefixes
(system prompts, few-shot preambles). This module is the serving-side
cache that lets `ServeLoop` skip re-prefilling them: a compressed token
radix trie whose nodes carry host-side snapshots of prefill state,
matched at admission and spliced into a decode lane through the
`repro_torch.surgery` primitives.

Two snapshot kinds live in the trie:

``RowsEntry`` — the PRE-pruning chunked-prefill workspace restricted to
prompt rows ``[0, depth)``: per-layer K/V rows plus the accumulated
attention column sums (`models.transformer.PrefillChunkState` fields,
batch axis squeezed). After the chunks covering ``[0, depth)`` have run,
those rows/sums depend only on tokens ``[0, depth)`` — columns past a
chunk's causal reach carry exactly-zero probability mass — so resuming
the remaining chunks on top of them repeats the from-scratch f32
accumulation order bit-for-bit (`Model.resume_prefill_chunk_state`).
This is what makes prefix reuse exact under the paper's position-
dependent static pruning: the snapshot is taken BEFORE `prefill_fill`'s
sink/recent-anchored top-k rewrites the slot layout, and before the
int8 mirrors quantize, so it is a valid donor for any continuation and
for both bf16 and int8 caches. ``depth`` is always a multiple of the
engine's prefill chunk size (the resume grid).

``StateEntry`` — the finalized batch-1 `DecodeState` (+ last-position
logits) of a completed prefill. An exact-prompt hit splices it straight
into a free lane (zero prefill dispatches). It can additionally serve
as a *prefix* donor for a longer prompt only when the static pruning
left its slot layout prefix-aligned — nothing evicted, positions the
identity, full precision — which `core/cache.prefix_slot_aligned`
checks; `ServeLoop` then derives a `RowsEntry` from it at insert time
(`core/cache.cache_prefix_rows`). A pruned (rewritten) layout is
rejected as a donor: its rows are a position-scattered subset, not the
raw prefix.

Eviction is LRU under a byte budget: every insert/match touches its
entry; inserts evict least-recently-used entries (any kind) until the
budget holds. Entries larger than the whole budget are evicted
immediately — the trie never over-commits. Nodes left with no entries
and no children are pruned; pass-through nodes are left unmerged (they
cost two pointers, not cache bytes).

The trie is pure host-side bookkeeping, so it adds zero device
dispatches to the admission path. Its snapshots are CPU tensors that
own their storage (numpy has no bf16): the caller copies into them
(`Tensor.to("cpu", copy=True)`), since on the CPU `.cpu()` returns the
live buffer itself, and the serving engine's in-place workspaces and
decode steps would then write through into the trie.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PrefixCache", "RowsEntry", "StateEntry"]


def _tree_nbytes(x: Any) -> int:
    """Total tensor/ndarray bytes in a nested tuple/list/dict/dataclass
    tree (the port's `DecodeState` and `KVCache` are dataclasses of torch
    tensors)."""
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    if isinstance(x, dict):
        return sum(_tree_nbytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(_tree_nbytes(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return sum(_tree_nbytes(getattr(x, f.name))
                   for f in dataclasses.fields(x))
    return 0


@dataclasses.dataclass
class RowsEntry:
    """Pre-pruning workspace rows covering prompt tokens ``[0, depth)``.

    k/v: ``[L_attn, Hk, depth, dh]`` compute-dtype rows; acc:
    ``[L_attn, Hk, depth]`` f32 accumulated column sums — exactly the
    `PrefillChunkState` prefix a from-scratch chunked prefill holds
    after its first ``depth / C`` chunks (batch axis squeezed)."""
    depth: int
    k: torch.Tensor
    v: torch.Tensor
    acc: torch.Tensor
    nbytes: int = 0

    def __post_init__(self):
        if not self.nbytes:
            self.nbytes = (_tree_nbytes(self.k) + _tree_nbytes(self.v)
                           + _tree_nbytes(self.acc))


@dataclasses.dataclass
class StateEntry:
    """Finalized batch-1 decode state of a completed prefill.

    `state` is the full DecodeState with CPU tensor leaves (every
    KVCache field, including quantized mirrors); `logits` the last-valid-
    position logits ``[V]`` that seed the first generated token."""
    length: int
    bucket: int
    logits: torch.Tensor
    state: Any
    nbytes: int = 0

    def __post_init__(self):
        if not self.nbytes:
            self.nbytes = _tree_nbytes(self.logits) + _tree_nbytes(self.state)


class _Node:
    """Radix-trie node; `edge` is the compressed token run INTO the node."""
    __slots__ = ("edge", "children", "parent", "rows", "state")

    def __init__(self, edge: Tuple[int, ...] = (),
                 parent: Optional["_Node"] = None):
        self.edge = edge
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.rows: Optional[RowsEntry] = None
        self.state: Optional[StateEntry] = None


def _norm(tokens: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(t) for t in np.asarray(tokens).reshape(-1))


class PrefixCache:
    """Compressed token radix trie with LRU eviction under a byte budget.

    ``capacity_bytes <= 0`` disables insertion (every insert is refused)
    while keeping lookups well-defined — a convenient "off" state."""

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self.root = _Node()
        self.bytes = 0
        self.entries = 0
        self.inserts = 0
        self.evictions = 0
        # insertion-ordered dict as the LRU queue: lid -> (node, kind)
        self._lru: Dict[int, Tuple[_Node, str]] = {}
        self._lid: Dict[Tuple[int, str], int] = {}
        self._next_lid = 0

    # -- trie plumbing ------------------------------------------------------

    def _descend(self, tokens: Tuple[int, ...], create: bool
                 ) -> Optional[_Node]:
        """Node whose root-path spells `tokens` exactly, splitting edges
        on the way when `create`; None when absent and not creating."""
        node, i, n = self.root, 0, len(tokens)
        while i < n:
            child = node.children.get(tokens[i])
            if child is None:
                if not create:
                    return None
                child = _Node(tokens[i:], parent=node)
                node.children[tokens[i]] = child
                return child
            edge = child.edge
            m = 0
            while (m < len(edge) and i + m < n and edge[m] == tokens[i + m]):
                m += 1
            if m == len(edge):
                node, i = child, i + m
                continue
            if not create:
                return None
            # split `child`'s edge at m: node -> mid -> child
            mid = _Node(edge[:m], parent=node)
            node.children[edge[0]] = mid
            child.edge = edge[m:]
            child.parent = mid
            mid.children[edge[m]] = child
            node, i = mid, i + m
        return node

    def _prefix_nodes(self, tokens: Tuple[int, ...]
                      ) -> Iterator[Tuple[int, _Node]]:
        """Yield (depth, node) for every node whose root-path is a full
        prefix of `tokens`, shallowest first."""
        node, depth, n = self.root, 0, len(tokens)
        while depth < n:
            child = node.children.get(tokens[depth])
            if child is None:
                return
            edge = child.edge
            if depth + len(edge) > n:
                return
            for j, t in enumerate(edge):
                if tokens[depth + j] != t:
                    return
            depth += len(edge)
            node = child
            yield depth, node

    def _prune(self, node: _Node) -> None:
        """Drop entry-less childless nodes up the parent chain."""
        while (node.parent is not None and not node.children
               and node.rows is None and node.state is None):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent

    # -- LRU ----------------------------------------------------------------

    def _touch(self, node: _Node, kind: str) -> None:
        lid = self._lid.get((id(node), kind))
        if lid is not None:
            self._lru[lid] = self._lru.pop(lid)          # move to MRU end
            return
        lid = self._next_lid
        self._next_lid += 1
        self._lru[lid] = (node, kind)
        self._lid[(id(node), kind)] = lid

    def _detach(self, node: _Node, kind: str, evicted: bool) -> None:
        entry = getattr(node, kind)
        if entry is None:
            return
        setattr(node, kind, None)
        self.bytes -= entry.nbytes
        self.entries -= 1
        if evicted:
            self.evictions += 1
        lid = self._lid.pop((id(node), kind), None)
        if lid is not None:
            self._lru.pop(lid, None)
        self._prune(node)

    def _evict_to_budget(self) -> None:
        while self.bytes > self.capacity and self._lru:
            lid = next(iter(self._lru))
            node, kind = self._lru[lid]
            self._detach(node, kind, evicted=True)

    # -- public API ---------------------------------------------------------

    def insert_rows(self, tokens: Sequence[int], entry: RowsEntry) -> bool:
        """Attach a workspace-rows donor at depth ``len(tokens)``. Returns
        False when the budget refuses it (capacity <= 0)."""
        tokens = _norm(tokens)
        assert entry.depth == len(tokens), (entry.depth, len(tokens))
        if self.capacity <= 0:
            return False
        node = self._descend(tokens, create=True)
        self._detach(node, "rows", evicted=False)        # replace in place
        node.rows = entry
        self.bytes += entry.nbytes
        self.entries += 1
        self.inserts += 1
        self._touch(node, "rows")
        self._evict_to_budget()
        return node.rows is entry

    def insert_state(self, tokens: Sequence[int], entry: StateEntry) -> bool:
        """Attach a finalized-state entry at the full-prompt node."""
        tokens = _norm(tokens)
        assert entry.length == len(tokens), (entry.length, len(tokens))
        if self.capacity <= 0:
            return False
        node = self._descend(tokens, create=True)
        self._detach(node, "state", evicted=False)
        node.state = entry
        self.bytes += entry.nbytes
        self.entries += 1
        self.inserts += 1
        self._touch(node, "state")
        self._evict_to_budget()
        return node.state is entry

    def match_rows(self, tokens: Sequence[int],
                   cap: int) -> Optional[RowsEntry]:
        """Deepest rows donor whose depth divides the prompt's prefix and
        is ``<= cap`` (the caller's resume-grid ceiling)."""
        tokens = _norm(tokens)
        best: Optional[Tuple[int, _Node]] = None
        for depth, node in self._prefix_nodes(tokens):
            if depth > cap:
                break
            if node.rows is not None:
                best = (depth, node)
        if best is None:
            return None
        _, node = best
        self._touch(node, "rows")
        return node.rows

    def match_state(self, tokens: Sequence[int]) -> Optional[StateEntry]:
        """Exact full-prompt hit, or None."""
        tokens = _norm(tokens)
        node = self._descend(tokens, create=False)
        if node is None or node.state is None:
            return None
        self._touch(node, "state")
        return node.state

    def stats(self) -> Dict[str, float]:
        return {"prefix_cache_bytes": float(self.bytes),
                "prefix_cache_entries": float(self.entries),
                "prefix_inserts": float(self.inserts),
                "prefix_evictions": float(self.evictions)}
