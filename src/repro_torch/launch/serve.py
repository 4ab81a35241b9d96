"""Serving engine — the port of `repro/launch/serve.py` (the greedy core,
chunked admission and the prefix cache).

`ServeLoop` keeps a fixed number of decode lanes and a request queue.
Admission is grouped: every arrived request that pads to the same bucket
is prefilled in ONE batched pass (`Model.prefill_group`) and spliced into
free lanes with one multi-lane insert (`transformer.lanes_insert`),
shortest bucket first under load (with aging, so a long prompt cannot
starve). Decode runs in blocks of `block` steps over all lanes; a lane that
hits EOS or its budget stops writing its cache at once (an in-device
`active` mask) and is refilled from the queue at the next block boundary.
With `chunk_prefill=C` a prompt whose bucket exceeds C is prefilled in
C-token slices on a reserved lane, one slice between decode blocks. With
`prefix_cache_bytes=N` a radix trie of host snapshots (`prefix_cache.py`)
lets a repeated prompt splice its cached state with no prefill, and a
prompt that shares a cached prefix resume its sliced prefill past it.

Not ported yet: sampling knobs, preemption, fault tolerance, the degrade
ladder and meshes.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core import baselines
from repro_torch.device import resolve_device
from repro_torch.launch.prefix_cache import PrefixCache, RowsEntry, StateEntry
from repro_torch.models.transformer import (DecodeState, Model,
                                            PrefillChunkState)
from repro_torch.surgery import (cache_prefix_rows, state_lane_insert,
                                 state_lanes_insert)

# ---------------------------------------------------------------------------
# Prompt-length buckets: prompts are right-padded to a small doubling grid
# and prefilled with a true-length mask, so prompts of one bucket share a
# batched admission prefill.
# ---------------------------------------------------------------------------

MIN_BUCKET = 16
# rounds the FIFO head may be passed over for a shorter bucket under load
MAX_HEAD_SKIPS = 8


def bucket_length(t: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest bucket >= t. Default grid: powers of two from MIN_BUCKET.
    With an explicit grid, lengths beyond the largest bucket keep their
    exact length."""
    if buckets is None:
        return max(MIN_BUCKET, 2 ** math.ceil(math.log2(max(t, 1))))
    for b in buckets:
        if b >= t:
            return int(b)
    return t


def pad_to_bucket(prompt: np.ndarray,
                  buckets: Optional[Sequence[int]] = None
                  ) -> Tuple[np.ndarray, int]:
    """Right-pad `prompt` to its bucket → (padded [bucket], true length)."""
    prompt = np.asarray(prompt)
    t = len(prompt)
    b = bucket_length(t, buckets)
    if b == t:
        return prompt, t
    out = np.zeros(b, prompt.dtype)
    out[:t] = prompt
    return out, t


def _check_device(model: Model, device) -> None:
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"device={dev} but the model lives on {model.device}")


def greedy_generate(model: Model, params, batch, steps: int,
                    device="cuda"):
    """Prefill + `steps` greedy decode steps, one call per token →
    (tokens [B, steps], final state). tokens[:, 0] is the argmax of the
    prefill logits."""
    _check_device(model, device)
    logits, state = model.prefill(params, batch)
    toks = []
    tok = torch.argmax(logits, -1)
    for _ in range(steps):
        toks.append(tok)
        logits, state = model.decode_step(params, state, tok)
        tok = torch.argmax(logits, -1)
    return torch.stack(toks, dim=1), state


def decode_block(model: Model, params, state, tok: torch.Tensor, steps: int):
    """`steps` greedy decode steps from token `tok` [B] →
    (state, next_tok [B], toks [steps, B]) with toks[0] == tok."""
    toks = []
    for _ in range(steps):
        toks.append(tok)
        logits, state = model.decode_step(params, state, tok)
        tok = torch.argmax(logits, -1)
    return state, tok, torch.stack(toks)


# ---------------------------------------------------------------------------
# Requests + per-request serving metrics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False, kw_only=True)
class Request:
    """One generation request (keyword-only; `submit()` assigns `rid`).
    `arrival` is seconds from `run()` start (0 = already waiting)."""
    prompt: np.ndarray
    max_new: Optional[int] = None        # None → the loop's default
    arrival: float = 0.0
    reuse_prefix: bool = True            # consult + feed the prefix cache
    # engine-assigned fields — never pass these to the constructor
    rid: int = -1
    bucket: int = 0            # memoized pad width under the loop's grid


class RequestHandle:
    """Ticket returned by `ServeLoop.submit(Request(...))`: a live view of
    one request's progress."""
    __slots__ = ("rid", "_loop")

    def __init__(self, loop: "ServeLoop", rid: int):
        self.rid = rid
        self._loop = loop

    @property
    def stats(self) -> "RequestStats":
        return self._loop.stats[self.rid]

    @property
    def done(self) -> bool:
        return self.rid in self._loop._finished

    @property
    def tokens(self) -> List[int]:
        return list(self.stats.tokens)

    def __repr__(self) -> str:
        return f"RequestHandle(rid={self.rid}, done={self.done})"


@dataclasses.dataclass
class RequestStats:
    rid: int
    prompt_len: int
    max_new: int
    lane: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_arrival: float = 0.0     # run-relative seconds
    t_admit: float = 0.0       # prefilled + spliced into a lane
    t_first: float = 0.0       # first generated token on the host
    t_done: float = 0.0
    occupancy: float = 0.0     # mean cache fill fraction at completion
    bucket: int = 0            # padded prefill width
    prefill_chunks: int = 1    # dispatches the prefill was sliced into
    prefix_tokens: int = 0     # prompt tokens served from the prefix cache
    prefix_exact: bool = False  # whole prompt hit (state splice, no prefill)

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrival


@dataclasses.dataclass
class _ChunkedPrefill:
    """Host-side progress of the one in-flight time-sliced prefill."""
    req: Request
    lane: int                  # reserved for it until the splice
    bucket: int                # workspace rows (a multiple of the chunk)
    padded: np.ndarray
    pstate: PrefillChunkState
    n_chunks: int              # chunks holding real tokens
    next_chunk: int = 0
    x_last: Optional[torch.Tensor] = None   # hidden of the latest chunk
    base: int = 0              # rows [0, base) came from a prefix-cache donor
    collect: bool = False      # snapshot chunk boundaries for the trie
    # (boundary q, host copy of acc[:, 0, :, :q]): acc columns keep
    # absorbing mass from later query rows, so each boundary keeps its own
    # copy, taken right after the chunk that ends at q; the K/V rows are
    # write-once and are copied once, after the splice
    snap_acc: List[Tuple[int, torch.Tensor]] = dataclasses.field(
        default_factory=list)


class ServeLoop:
    """Lane-granular continuous batching: fixed decode lanes + request queue.

        loop = ServeLoop(model, params, lanes=4, eos=2, block=8)
        h = loop.submit(Request(prompt=prompt, max_new=64))
        stats = loop.run()                    # List[RequestStats]
        h.done, h.tokens

    Scheduling follows the reference: at each admission point the group is
    every arrived request of one bucket (up to the free lanes) — the FIFO
    head's bucket off load, the shortest bucket under load, and the head's
    bucket once it has been passed over MAX_HEAD_SKIPS rounds in a row.
    A group is prefilled at exactly its size (eager PyTorch compiles
    nothing, so the reference's power-of-two row padding has no use here).
    `counters` tracks `prefill_dispatches`, `admit_dispatches`,
    `grouped_requests`, `chunk_dispatches`, `decode_blocks`,
    `decode_steps` and `nonfinite_lanes` (admissions or active lanes whose
    logits were not finite).

    Chunked admission (`chunk_prefill=C`): a prompt whose bucket exceeds C
    reserves a free lane and is prefilled in C-token slices
    (`Model.prefill_chunk`, then `prefill_finalize`) over a workspace of
    the bucket rounded up to a multiple of C; only the chunks that hold
    real tokens run. Each round of `run()` schedules, runs one slice, then
    one decode block, so live lanes keep decoding while a long prompt
    prefills. At most one sliced prefill is in flight; while one is, a
    round whose target needs slicing admits the shortest bucket that does
    not instead. `RequestStats.prefill_chunks` counts a request's slices.
    A model without `supports_chunked_prefill()` falls back to whole-bucket
    admission.

    Prefix cache (`prefix_cache_bytes=N > 0`): a host-side radix trie under
    an N-byte LRU budget. A solo whole-bucket admission and every sliced
    one look the prompt up first: an exact hit splices the cached
    finalized state into the lane (no prefill dispatch); a sliced prefill
    may instead resume from the deepest cached chunk boundary of its
    prompt and run only the chunks past it (`resume_prefill_chunk_state`),
    equal to the run from row 0 bit for bit. Completed prefills insert
    their finalized state and, for sliced ones, the workspace rows at each
    chunk boundary inside the prompt; a whole-bucket prefill whose pruning
    kept every token donates rows too when `chunk_prefill` equals
    `cfg.attn_chunk` (the same column-sum order). Grouped admissions of
    two or more neither look up nor insert. `Request(reuse_prefix=False)`
    opts out. Counters: `prefix_lookups`, `prefix_hits`,
    `prefix_exact_hits`, `prefix_copies`, `prefix_tokens_reused`,
    `prefix_inserts`, `prefix_evictions`; `prefix_host_s` holds the host
    seconds of the trie's snapshot copies (`insert_s`) and of exact-hit
    splices (`splice_s`).
    """

    def __init__(self, model: Model, params, lanes: int, max_new: int = 64,
                 eos: int = -1, block: int = 1,
                 buckets: Union[str, Sequence[int], None] = "auto",
                 chunk_prefill: int = 0, group_admit: bool = True,
                 prefix_cache_bytes: int = 0, device="cuda"):
        _check_device(model, device)
        self.model = model
        self.params = params
        self.lanes = lanes
        self.max_new = max_new
        self.eos = eos
        self.block = max(1, block)
        self.buckets = (tuple(buckets)
                        if isinstance(buckets, (list, tuple)) else buckets)
        self.chunk_prefill = max(0, chunk_prefill)
        if self.chunk_prefill and not model.supports_chunked_prefill():
            self.chunk_prefill = 0            # whole-bucket admission
        self._pending: Optional[_ChunkedPrefill] = None
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(prefix_cache_bytes) if prefix_cache_bytes > 0
            else None)
        # rows donors ride the sliced path: a resume repeats the donor's
        # column-sum order only on the donor's own chunk grid
        self._rows_reuse = (self.prefix_cache is not None
                            and self.chunk_prefill > 0)
        self.prefix_host_s = {"insert_s": 0.0, "splice_s": 0.0}
        self.group_admit = bool(group_admit)
        self._head_skips = 0
        self.device = model.device
        self.state = None
        self.tok = None
        self.active = np.zeros(lanes, bool)
        self.remaining = np.zeros(lanes, np.int32)
        self.outputs: List[List[int]] = [[] for _ in range(lanes)]
        self._arrivals: Deque[Request] = deque()       # not yet arrived
        self._waiting: List[Request] = []              # arrived, FIFO
        self.stats: Dict[int, RequestStats] = {}
        self.completed: List[RequestStats] = []
        self._lane_rid: List[Optional[int]] = [None] * lanes
        self._next_rid = 0
        self._t0: Optional[float] = None
        self._finished: set = set()
        self.counters: Dict[str, int] = {
            "prefill_dispatches": 0, "admit_dispatches": 0,
            "grouped_requests": 0, "chunk_dispatches": 0,
            "decode_blocks": 0, "decode_steps": 0, "nonfinite_lanes": 0,
            "prefix_lookups": 0, "prefix_hits": 0, "prefix_exact_hits": 0,
            "prefix_copies": 0, "prefix_tokens_reused": 0,
            "prefix_inserts": 0, "prefix_evictions": 0,
        }

    def _now(self) -> float:
        return 0.0 if self._t0 is None else time.monotonic() - self._t0

    # -- request intake ------------------------------------------------------

    def submit(self, request: Request) -> RequestHandle:
        """Queue one request → its handle."""
        if not isinstance(request, Request):
            raise TypeError("submit() takes a Request(prompt=..., max_new=...)")
        if request.rid >= 0:
            raise ValueError(f"Request already submitted (rid={request.rid})")
        req = request
        req.prompt = np.asarray(req.prompt)
        if len(req.prompt) == 0:
            raise ValueError("empty prompt")
        if req.max_new is None:
            req.max_new = self.max_new
        req.rid = self._next_rid
        self._next_rid += 1
        req.bucket = self._bucket_of(req)
        # keep arrival order (FIFO among ties)
        idx = len(self._arrivals)
        while idx and self._arrivals[idx - 1].arrival > req.arrival:
            idx -= 1
        self._arrivals.insert(idx, req)
        self.stats[req.rid] = RequestStats(req.rid, len(req.prompt),
                                           req.max_new, t_arrival=req.arrival)
        return RequestHandle(self, req.rid)

    def _bucket_of(self, req: Request) -> int:
        if self.buckets is None:
            return len(req.prompt)
        grid = None if self.buckets == "auto" else self.buckets
        return bucket_length(len(req.prompt), grid)

    def _padded_prompt(self, req: Request) -> np.ndarray:
        if self.buckets is None:
            return req.prompt
        grid = None if self.buckets == "auto" else self.buckets
        return pad_to_bucket(req.prompt, grid)[0]

    # -- scheduling ----------------------------------------------------------

    def _drain_arrivals(self, now: float) -> None:
        while self._arrivals and self._arrivals[0].arrival <= now:
            self._waiting.append(self._arrivals.popleft())

    def _free_lanes(self) -> List[int]:
        """Lanes without a request; a sliced prefill's reserved lane is not
        free."""
        reserved = None if self._pending is None else self._pending.lane
        return [i for i in range(self.lanes)
                if self._lane_rid[i] is None and i != reserved]

    def _needs_chunking(self, bucket: int) -> bool:
        return 0 < self.chunk_prefill < bucket

    def schedule(self) -> int:
        """Admit arrived requests into free lanes, one bucket group per
        round, until no lane or no arrived request is left → admitted (a
        sliced prefill counts once it has been opened)."""
        n = 0
        while True:
            self._drain_arrivals(self._now())
            free = self._free_lanes()
            if not self._waiting or not free:
                return n
            head = self._waiting[0]
            if not self.group_admit:
                target, take = head.bucket, 1
            else:
                target, take = head.bucket, len(free)
                if len(self._waiting) > len(free):
                    shortest = min(r.bucket for r in self._waiting)
                    if (shortest != head.bucket
                            and self._head_skips < MAX_HEAD_SKIPS):
                        target = shortest
            if (self.group_admit and self._pending is not None
                    and self._needs_chunking(target)):
                # one sliced prefill at a time: admit the shortest bucket
                # that needs no slicing instead of idling the free lanes
                alts = [r.bucket for r in self._waiting
                        if not self._needs_chunking(r.bucket)]
                if not alts:
                    return n
                target = min(alts)
            if self._needs_chunking(target):
                if self._pending is not None:
                    return n
                req = next(r for r in self._waiting if r.bucket == target)
                self._waiting.remove(req)
                self._head_skips = 0 if req is head else self._head_skips + 1
                self._start_chunked(free[0], req)
                n += 1
                continue
            group = [r for r in self._waiting if r.bucket == target][:take]
            for r in group:
                self._waiting.remove(r)
            self._head_skips = 0 if head in group else self._head_skips + 1
            if len(group) == 1:
                self._admit_lane(free[0], group[0])
            else:
                self._admit_group(free[:len(group)], group)
            n += len(group)

    def _ensure_state(self) -> None:
        if self.state is None:
            self.state = self.model.init_decode_state(self.lanes)
            self.tok = torch.zeros(self.lanes, dtype=torch.long,
                                   device=self.device)

    def _admit_lane(self, lane: int, req: Request) -> None:
        """Solo whole-bucket admission: an exact-prompt hit in the prefix
        cache splices the cached state; otherwise one prefill, spliced,
        then inserted into the trie as a donor."""
        self._ensure_state()
        hit, _ = self._cache_match(req, rows_cap=None)
        if hit is not None:
            self._splice_cached(lane, req, hit)
            return
        logits, fresh, bucket = self._admit_group([lane], [req])
        self._cache_insert_finalized(req, logits[0], fresh, bucket)

    def _admit_group(self, lanes: List[int], group: List[Request]
                     ) -> Tuple[torch.Tensor, DecodeState, int]:
        """One batched prefill of `group` and one splice into `lanes` →
        (logits, prefilled state, bucket)."""
        self._ensure_state()
        rows = np.stack([self._padded_prompt(r) for r in group])
        lengths = np.array([len(r.prompt) for r in group], np.int32)
        logits, fresh = self.model.prefill_group(
            self.params, torch.as_tensor(rows, device=self.device),
            torch.as_tensor(lengths, device=self.device))
        self.counters["prefill_dispatches"] += 1
        if len(group) > 1:
            self.counters["grouped_requests"] += len(group)
        self._splice(lanes, group, logits, fresh, bucket=len(rows[0]))
        return logits, fresh, len(rows[0])

    def _splice(self, lanes: List[int], group: List[Request], logits, fresh,
                bucket: int, prefill_chunks: int = 1,
                prefix_tokens: int = 0) -> None:
        """Insert the prefilled batch-G state into `lanes` (row i into
        lanes[i]); each lane's first token is the argmax of its logits."""
        self.counters["nonfinite_lanes"] += int(
            (~torch.isfinite(logits).all(dim=-1)).sum())
        src = np.full(self.lanes, -1, np.int64)
        src[lanes] = np.arange(len(group))
        state_lanes_insert(self.state, src, fresh)
        lane_t = torch.as_tensor(lanes, dtype=torch.long, device=self.device)
        self.tok[lane_t] = torch.argmax(logits, -1)
        self.counters["admit_dispatches"] += 1
        now = self._now()
        for lane, req in zip(lanes, group):
            self._register_admit(lane, req, now, bucket, prefill_chunks,
                                 prefix_tokens)

    def _register_admit(self, lane: int, req: Request, now: float,
                        bucket: int, prefill_chunks: int,
                        prefix_tokens: int, prefix_exact: bool = False
                        ) -> None:
        """Host-side bookkeeping for a request just spliced into `lane`."""
        self.active[lane] = req.max_new > 0
        self.remaining[lane] = max(req.max_new, 0)
        self.outputs[lane] = []
        self._lane_rid[lane] = req.rid
        st = self.stats[req.rid]
        st.lane, st.t_admit, st.bucket = lane, now, bucket
        st.prefill_chunks = prefill_chunks
        st.prefix_tokens, st.prefix_exact = prefix_tokens, prefix_exact
        if req.max_new <= 0:                   # prefill-only request
            st.t_first = now
            self._finish_lane(lane, now)

    # -- prefix cache ----------------------------------------------------------

    def _cache_match(self, req: Request, rows_cap: Optional[int]
                     ) -> Tuple[Optional[StateEntry], Optional[RowsEntry]]:
        """One admission-time lookup → (exact-state hit, rows donor), at
        most one not None. `rows_cap` bounds the donor depth (the deepest
        chunk boundary strictly inside the prompt); None skips the rows
        search (whole-bucket admission)."""
        pc = self.prefix_cache
        if pc is None or not req.reuse_prefix:
            return None, None
        self.counters["prefix_lookups"] += 1
        st = pc.match_state(req.prompt)
        if st is not None:
            self.counters["prefix_hits"] += 1
            self.counters["prefix_exact_hits"] += 1
            return st, None
        if rows_cap is not None and rows_cap >= self.chunk_prefill:
            rows = pc.match_rows(req.prompt, rows_cap)
            if rows is not None:
                self.counters["prefix_hits"] += 1
                return None, rows
        return None, None

    def _splice_cached(self, lane: int, req: Request,
                       entry: StateEntry) -> None:
        """Admit from an exact-prompt hit: copy the cached finalized state
        into `lane` (no prefill dispatch); its first token is the argmax of
        the cached logits, so a greedy repeat reproduces the original
        stream."""
        t0 = time.perf_counter()
        state_lane_insert(self.state, lane, entry.state)
        self.tok[lane] = torch.argmax(entry.logits.to(self.device), -1)
        self.prefix_host_s["splice_s"] += time.perf_counter() - t0
        self.counters["admit_dispatches"] += 1
        self.counters["prefix_copies"] += 1
        self.counters["prefix_tokens_reused"] += entry.length
        self._register_admit(lane, req, self._now(), entry.bucket,
                             prefill_chunks=0, prefix_tokens=entry.length,
                             prefix_exact=True)

    def _sync_cache_counters(self) -> None:
        pc = self.prefix_cache
        self.counters["prefix_inserts"] = pc.inserts
        self.counters["prefix_evictions"] = pc.evictions

    def _state_entry(self, req: Request, bucket: int, logits,
                     fresh: DecodeState) -> StateEntry:
        """A trie entry holding host copies of a finalized batch-1 state
        and its logits."""
        return StateEntry(
            length=len(req.prompt), bucket=bucket,
            logits=logits.to("cpu", copy=True),
            state=DecodeState(kv=fresh.kv.map(
                lambda a: a.to("cpu", copy=True))))

    def _cache_insert_finalized(self, req: Request, logits,
                                fresh: DecodeState, bucket: int) -> None:
        """Insert a completed whole-bucket prefill into the trie: the
        finalized state always; also a rows donor when the static pruning
        left the prefix slot-aligned, the prompt length sits on the resume
        chunk grid, and that grid is the donor's column-sum grid
        (cfg.attn_chunk)."""
        pc = self.prefix_cache
        if pc is None or not req.reuse_prefix:
            return
        t0 = time.perf_counter()
        entry = self._state_entry(req, bucket, logits, fresh)
        pc.insert_state(req.prompt, entry)
        c = self.chunk_prefill
        n = len(req.prompt)
        if (self._rows_reuse and n % c == 0
                and c == self.model.cfg.attn_chunk):
            rows = cache_prefix_rows(entry.state.kv, n)
            if rows is not None:
                pc.insert_rows(req.prompt, RowsEntry(n, *rows))
        self.prefix_host_s["insert_s"] += time.perf_counter() - t0
        self._sync_cache_counters()

    def _cache_insert_chunked(self, p: _ChunkedPrefill, logits,
                              fresh: DecodeState) -> None:
        """Insert a finished sliced prefill: the finalized state at the
        full prompt, and one rows donor per collected chunk boundary (the
        K/V rows [0, q) of the workspace, which nothing writes after
        their chunk, beside that boundary's own acc copy)."""
        pc = self.prefix_cache
        if pc is None or not p.req.reuse_prefix:
            return
        t0 = time.perf_counter()
        tokens = p.req.prompt
        pc.insert_state(tokens, self._state_entry(p.req, p.bucket, logits,
                                                  fresh))
        for q, acc_q in p.snap_acc:
            pc.insert_rows(tokens[:q], RowsEntry(
                q, p.pstate.k[:, 0, :, :q].to("cpu", copy=True),
                p.pstate.v[:, 0, :, :q].to("cpu", copy=True), acc_q))
        self.prefix_host_s["insert_s"] += time.perf_counter() - t0
        self._sync_cache_counters()

    # -- chunked (time-sliced) admission ---------------------------------------

    def _start_chunked(self, lane: int, req: Request) -> None:
        """Reserve `lane` and open a sliced prefill of `req`. The workspace
        is the bucket rounded up to a multiple of the chunk, so every slice
        is full width; only the chunks holding real tokens are run.

        Prefix cache: an exact-prompt hit splices the cached state instead
        (no slices, no reserved lane); a rows hit at depth p copies the
        cached rows into the workspace and resumes at chunk p / C."""
        self._ensure_state()
        c = self.chunk_prefill
        # the final chunk (its hidden feeds the logits) always runs
        cap = ((len(req.prompt) - 1) // c) * c
        hit, rows = self._cache_match(req, rows_cap=cap)
        if hit is not None:
            self._splice_cached(lane, req, hit)
            return
        ws = math.ceil(req.bucket / c) * c
        padded = np.zeros(ws, req.prompt.dtype)
        padded[:len(req.prompt)] = req.prompt
        if rows is not None:
            pstate = self.model.resume_prefill_chunk_state(
                rows.k, rows.v, rows.acc, ws)
            base = rows.depth
            self.counters["prefix_copies"] += 1
            self.counters["prefix_tokens_reused"] += base
        else:
            pstate = self.model.init_prefill_chunk_state(1, ws)
            base = 0
        self._pending = _ChunkedPrefill(
            req=req, lane=lane, bucket=ws, padded=padded, pstate=pstate,
            n_chunks=math.ceil(len(req.prompt) / c), next_chunk=base // c,
            base=base, collect=self._rows_reuse and req.reuse_prefix)

    def _advance_chunked(self) -> bool:
        """Run ONE slice of the in-flight sliced prefill, and after its last
        slice the finalize and the splice → whether a slice ran."""
        p = self._pending
        if p is None:
            return False
        c = self.chunk_prefill
        row0 = p.next_chunk * c
        tok_c = torch.as_tensor(p.padded[None, row0:row0 + c],
                                device=self.device)
        length = torch.as_tensor([len(p.req.prompt)], dtype=torch.int32,
                                 device=self.device)
        p.x_last, p.pstate = self.model.prefill_chunk(
            self.params, p.pstate, tok_c, row0, length)
        self.counters["chunk_dispatches"] += 1
        p.next_chunk += 1
        q = p.next_chunk * c
        if p.collect and p.base < q <= (len(p.req.prompt) // c) * c:
            # acc columns [0, q) depend only on tokens [0, q) (columns past
            # a chunk's causal reach take exactly zero mass): with the K/V
            # rows, a bit-exact resume donor for any continuation. A
            # boundary whose chunk holds pads (q > prompt length) is not
            # taken.
            t0 = time.perf_counter()
            p.snap_acc.append((q, p.pstate.acc[:, 0, :, :q].to(
                "cpu", copy=True)))
            self.prefix_host_s["insert_s"] += time.perf_counter() - t0
        if p.next_chunk >= p.n_chunks:
            logits, fresh = self.model.prefill_finalize(
                self.params, p.pstate, p.x_last, row0, length)
            self.counters["prefill_dispatches"] += 1
            self._pending = None
            self._splice([p.lane], [p.req], logits, fresh, bucket=p.bucket,
                         prefill_chunks=p.n_chunks, prefix_tokens=p.base)
            # into the trie after the splice: the admission does not wait
            # for the host copies
            self._cache_insert_chunked(p, logits[0], fresh)
        return True

    # -- decode --------------------------------------------------------------

    def _step_block(self) -> None:
        """Decode `block` steps over every lane. A lane emits its carried
        token while active; it stops at EOS (never emitted) or when its
        budget is spent, and from then on its cache rows stay frozen."""
        dev = self.device
        active = torch.as_tensor(self.active, device=dev)
        rem = torch.as_tensor(self.remaining, device=dev)
        finite = torch.ones(self.lanes, dtype=torch.bool, device=dev)
        tok = self.tok
        toks, emits = [], []
        for _ in range(self.block):
            logits, self.state = self.model.decode_step(
                self.params, self.state, tok, active)
            finite &= torch.isfinite(logits).all(dim=-1) | ~active
            emit = active & (rem > 0) & (tok != self.eos)
            rem = rem - emit.to(rem.dtype)
            toks.append(tok)
            emits.append(emit)
            active = emit & (rem > 0)
            tok = torch.argmax(logits, -1)
        self.tok = tok
        self.counters["decode_blocks"] += 1
        self.counters["decode_steps"] += self.block
        host_toks = torch.stack(toks).cpu().numpy()        # [steps, lanes]
        host_emit = torch.stack(emits).cpu().numpy()
        was_active = self.active.copy()
        self.active = active.cpu().numpy()
        self.remaining = rem.cpu().numpy().astype(np.int32)
        self.counters["nonfinite_lanes"] += int(
            (~finite.cpu().numpy() & was_active).sum())
        now = self._now()
        for lane in np.flatnonzero(host_emit.any(axis=0)):
            if not self.outputs[lane]:
                self.stats[self._lane_rid[lane]].t_first = now
            self.outputs[lane].extend(
                host_toks[host_emit[:, lane], lane].tolist())
        for lane in np.flatnonzero(was_active & ~self.active):
            self._finish_lane(int(lane), now)

    def _finish_lane(self, lane: int, now: float) -> None:
        rid = self._lane_rid[lane]
        st = self.stats[rid]
        if st.t_first < st.t_admit:     # nothing emitted (first token EOS)
            st.t_first = now
        st.tokens = list(self.outputs[lane])
        st.t_done = now
        fill = self.state.kv.fill[:, lane].float()
        st.occupancy = float(fill.mean()) / self.state.kv.slots
        self.completed.append(st)
        self._finished.add(rid)
        self._lane_rid[lane] = None
        self.active[lane] = False

    # -- driver ----------------------------------------------------------------

    def run(self) -> List[RequestStats]:
        """Drive until the queue is drained and every lane is idle. Each
        round schedules, runs at most one prefill slice, then one decode
        block."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        while (self._arrivals or self._waiting or self.active.any()
               or self._pending is not None):
            admitted = self.schedule()
            sliced = self._advance_chunked()
            if self.active.any():
                self._step_block()
            elif not (admitted or sliced) and self._arrivals:
                time.sleep(min(max(self._arrivals[0].arrival - self._now(),
                                   0.0), 0.05))
        return self.completed

    def aggregate(self) -> Dict[str, float]:
        """Serving metrics over completed requests, plus the counters.

        With a prefix cache, also `prefix_hit_rate` (hits / lookups),
        `prefix_dedup_ratio` (prompt tokens served from the cache / prompt
        tokens of completed requests) and the trie's live bytes, entries,
        inserts and evictions."""
        out: Dict[str, float] = {k: float(v) for k, v in self.counters.items()}
        if self.prefix_cache is not None:
            self._sync_cache_counters()
            out.update({k: float(v) for k, v in
                        self.prefix_cache.stats().items()})
            lookups = self.counters["prefix_lookups"]
            out["prefix_hit_rate"] = (
                self.counters["prefix_hits"] / lookups if lookups else 0.0)
            prompt_toks = sum(s.prompt_len for s in self.completed)
            out["prefix_dedup_ratio"] = (
                sum(s.prefix_tokens for s in self.completed) / prompt_toks
                if prompt_toks else 0.0)
        if not self.completed:
            return {**out, "requests": 0.0, "tokens": 0.0,
                    "tokens_per_s": 0.0}
        toks = sum(len(s.tokens) for s in self.completed)
        wall = max(max(s.t_done for s in self.completed)
                   - min(s.t_arrival for s in self.completed), 1e-9)
        ttfts = [s.ttft for s in self.completed]
        return {**out, "requests": float(len(self.completed)),
                "tokens": float(toks), "wall_s": wall,
                "tokens_per_s": toks / wall,
                "mean_latency_s": float(np.mean([s.latency
                                                 for s in self.completed])),
                "p50_ttft_s": float(np.percentile(ttfts, 50)),
                "p99_ttft_s": float(np.percentile(ttfts, 99))}


# ---------------------------------------------------------------------------
# CLI — the reference's flags, plus --device
# ---------------------------------------------------------------------------

_NOT_PORTED = ("temperature", "top_k", "top_p")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="unicaim",
                    choices=["unicaim", "h2o", "streaming", "dense"])
    ap.add_argument("--fused", action="store_true",
                    help="single-pass fused decode engine (unicaim only)")
    ap.add_argument("--no-scan", action="store_true",
                    help="per-token greedy_generate loop instead of "
                         "decode_block")
    ap.add_argument("--serve", action="store_true",
                    help="continuous-batching demo: 2x batch staggered "
                         "variable-length requests through ServeLoop")
    ap.add_argument("--chunk-prefill", type=int, default=0,
                    help="chunked admission (--serve only): prompts whose "
                         "bucket exceeds N tokens prefill in N-token slices "
                         "between decode blocks (0 = whole-bucket)")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="BYTES",
                    help="radix-trie prefix cache byte budget (0 = off; "
                         "--serve only)")
    ap.add_argument("--no-buckets", action="store_true",
                    help="exact-length prefills instead of bucketed ones")
    ap.add_argument("--sequential-admit", action="store_true",
                    help="disable grouped admission (--serve only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="not ported yet (greedy only: must stay 0)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="not ported yet (must stay 0)")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="not ported yet (must stay 0)")
    ap.add_argument("--no-window", action="store_true",
                    help="accepted for the reference's command lines: the "
                         "port always decodes at full slot width, and the "
                         "kernel skips each lane's dead slot blocks")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                         "card — pass cpu to run the plain PyTorch path)")
    args = ap.parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name):
            ap.error(f"--{name.replace('_', '-')} is not ported yet")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    budget = max(64, args.prompt_len // 2)
    if args.policy == "unicaim":
        prune = baselines.unicaim(heavy=budget, reserve=64,
                                  select_k=max(16, budget // 8),
                                  fused=args.fused)
    elif args.policy == "h2o":
        prune = baselines.h2o(heavy=budget, reserve=64)
    elif args.policy == "streaming":
        prune = baselines.streaming(budget + 64)
    else:
        prune = baselines.dense(args.prompt_len + args.new_tokens)
    model = Model(cfg, prune, device=args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    if args.serve:
        loop = ServeLoop(model, params, lanes=args.batch,
                         max_new=args.new_tokens, block=8,
                         buckets=None if args.no_buckets else "auto",
                         chunk_prefill=args.chunk_prefill,
                         group_admit=not args.sequential_admit,
                         prefix_cache_bytes=args.prefix_cache,
                         device=args.device)
        lens = (args.prompt_len, max(8, args.prompt_len // 2),
                max(8, args.prompt_len - 7), max(8, args.prompt_len // 3))
        for i in range(2 * args.batch):
            loop.submit(Request(
                prompt=rng.integers(0, cfg.vocab_size, lens[i % len(lens)]),
                max_new=args.new_tokens // (1 + i % 2)))
        t0 = time.time()
        stats = loop.run()
        sync()
        dt = time.time() - t0
        agg = loop.aggregate()
        for s in stats:
            print(f"  req {s.rid}: lane={s.lane} prompt={s.prompt_len} "
                  f"bucket={s.bucket} chunks={s.prefill_chunks} "
                  f"new={len(s.tokens)} latency={s.latency:.2f}s "
                  f"ttft={s.ttft:.2f}s occ={s.occupancy:.2f}")
        print(f"arch={cfg.name} policy={args.policy} fused={args.fused} "
              f"device={model.device} served {len(stats)} reqs on "
              f"{args.batch} lanes in {dt:.2f}s "
              f"({agg['tokens_per_s']:.1f} tok/s, "
              f"p99_ttft={agg['p99_ttft_s']:.2f}s, "
              f"{loop.counters['prefill_dispatches']} prefill + "
              f"{loop.counters['chunk_dispatches']} chunk + "
              f"{loop.counters['admit_dispatches']} admit dispatches, "
              f"{loop.counters['grouped_requests']} reqs group-admitted)")
        if loop.prefix_cache is not None:
            print(f"prefix cache: hit_rate={agg['prefix_hit_rate']:.2f} "
                  f"dedup={agg['prefix_dedup_ratio']:.2f} "
                  f"{int(agg['prefix_cache_bytes'])} bytes, "
                  f"{int(agg['prefix_cache_entries'])} entries, "
                  f"{loop.counters['prefix_evictions']} evictions")
        return

    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    batch = {"tokens": torch.as_tensor(prompts, device=model.device)}
    t0 = time.time()
    if args.no_scan:
        toks, _ = greedy_generate(model, params, batch, args.new_tokens,
                                  device=args.device)
    else:
        logits, state = model.prefill(params, batch)
        _, _, toks = decode_block(model, params, state,
                                  torch.argmax(logits, -1), args.new_tokens)
        toks = toks.T
    sync()
    dt = time.time() - t0
    mode = "loop" if args.no_scan else "block"
    print(f"arch={cfg.name} policy={args.policy} mode={mode} "
          f"fused={args.fused} device={model.device} "
          f"cache_slots={prune.slots} generated {tuple(toks.shape)} in "
          f"{dt:.2f}s ({args.batch * args.new_tokens / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
