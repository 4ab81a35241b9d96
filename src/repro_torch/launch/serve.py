"""Serving engine — the port of `repro/launch/serve.py` (the engine's
core, chunked admission, the prefix cache, per-lane sampling knobs,
priority preemption, drain-aware reservation and fault tolerance).

`ServeLoop` keeps a fixed number of decode lanes and a request queue.
Admission is grouped: every arrived request that pads to the same bucket
is prefilled in ONE batched pass (`Model.prefill_group`) and spliced into
free lanes with one multi-lane insert (`transformer.lanes_insert`),
highest priority class first, shortest bucket first under load (with
aging, so a long prompt cannot starve). Decode runs in blocks of `block`
steps over all lanes (`decode_block_lanes`); a lane that hits its stop
token or its budget stops writing its cache at once (an in-device `active`
mask) and is refilled from the queue at the next block boundary. Every
lane carries its own sampling knobs, stop token and PRNG stream. With
every lane busy, a request of a strictly higher class preempts the
lowest-priority lane (its state is captured and it resumes token-identical
later), and requests predicted to fit within `reserve_blocks` decode blocks
are popped ahead of time. With `chunk_prefill=C` a prompt whose bucket
exceeds C is prefilled in C-token slices on a reserved lane, one slice
between decode blocks. With `prefix_cache_bytes=N` a radix trie of host
snapshots (`prefix_cache.py`) lets a repeated prompt splice its cached
state with no prefill, and a prompt that shares a cached prefix resume
its sliced prefill past it.

Fault tolerance: a request may carry a deadline or be cancelled through
its handle; a bounded queue (`max_queue`) rejects or sheds by priority; a
degrade ladder shortens the decode block and caps new budgets under
sustained pressure; the decode block's non-finite sentinel deactivates a
poisoned lane on the device, and the loop quarantines it and retries the
request token-identically (`max_retries`, then outcome "failed"); a
`runtime.chaos.ChaosConfig` injects NaN logits, stalls and blackouts; and
`run()` resolves a queue it cannot place instead of spinning. Every
request ends with one outcome: done, cancelled, deadline, rejected or
failed.

Lane sharding (`ServeLoop(mesh=n | LaneMesh)`, `launch/mesh.py`): the lane
batch splits into `shards` contiguous blocks of `lanes_per_shard` lanes,
each with its own `DecodeState`, tokens and generators on its shard's
device; decode runs `decode_block_lanes` once per shard
(`decode_block_lanes_sharded`), and nothing reads across shards.
Admission fills the shard with the most free lanes, one shard's lanes a
round, so a grouped prefill splices into one shard's state only.
"""
from __future__ import annotations

import argparse
import copy
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
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.launch.prefix_cache import PrefixCache, RowsEntry, StateEntry
from repro_torch.models.transformer import (DecodeState, Model,
                                            PrefillChunkState)
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.surgery import (cache_prefix_rows, state_lane_insert,
                                 state_lane_slice, state_lanes_insert)
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# Prompt-length buckets: prompts are right-padded to a small doubling grid
# and prefilled with a true-length mask, so prompts of one bucket share a
# batched admission prefill.
# ---------------------------------------------------------------------------

MIN_BUCKET = 16


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


def _same_device(dev: torch.device, model_dev: torch.device) -> torch.device:
    """`dev`, or the model's own device object when both name one device
    (``cuda`` and ``cuda:0`` are one card when card 0 is current)."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    if dev.type == model_dev.type and index(dev) == index(model_dev):
        return model_dev
    return dev


def _model_on(model: Model, params, dev: torch.device):
    """A copy of the model facade on `dev`, and the params copied there."""
    m = copy.copy(model)
    m.device = dev
    return m, tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# The next-token rule. jax.random.categorical(key, x) is
# argmax(jax.random.gumbel(key, x.shape) + x), so the rule takes its Gumbel
# noise as an argument: the same noise gives the reference's tokens, and
# the port draws it from its own torch.Generators.
# ---------------------------------------------------------------------------

TINY = torch.finfo(torch.float32).tiny


def gumbel_noise(gens: Sequence[torch.Generator], v: int,
                 device) -> torch.Tensor:
    """[len(gens), v] f32 Gumbel noise, row i drawn from gens[i] as
    jax.random.gumbel draws it: -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.stack([torch.rand(v, generator=g, device=device)
                     for g in gens])
    return -torch.log(-torch.log(u.clamp_min_(TINY)))


def _next_token_lanes(logits: torch.Tensor, noise: torch.Tensor,
                      temperature: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """Per-lane next-token rule; every knob is a [B] tensor.

    logits [B, V]; noise [B, V] f32 Gumbel noise. Rows with temperature
    <= 0 take the argmax of the RAW logits (noise unused); sampled rows
    truncate to the top_k highest logits first (top_k <= 0 disables; the
    k-th threshold comes from one descending sort), then to the minimal
    top-p nucleus (top_p outside (0, 1) disables), then take
    argmax(noise + logits / temperature). No host sync."""
    v = logits.shape[-1]
    greedy = temperature <= 0
    t = torch.where(greedy, 1.0, temperature)[:, None]     # no div-by-0
    sl = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(sl, -1, (top_k.long().clamp(1, v) - 1)[:, None])
    use_k = (top_k > 0)[:, None]
    lg = torch.where(use_k & (logits < kth), -math.inf, logits)
    # masking the tail of an already-sorted row keeps it sorted, so the
    # nucleus scan runs over the top-k-truncated distribution directly
    sl = torch.where(use_k & (sl < kth), -math.inf, sl)
    p = torch.softmax(sl / t, dim=-1)
    # a token stays iff the mass BEFORE it is < top_p (the first always)
    keep = torch.cumsum(p, dim=-1) - p < top_p[:, None]
    cut = torch.where(keep, sl, math.inf).amin(dim=-1, keepdim=True)
    use_p = ((top_p > 0) & (top_p < 1))[:, None]
    lg = torch.where(use_p & (lg < cut), -math.inf, lg)
    sampled = torch.argmax(noise + lg / t, dim=-1)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)


def _next_token(logits: torch.Tensor, noise: Optional[torch.Tensor],
                temperature: float, top_k: int,
                top_p: float = 0.0) -> torch.Tensor:
    """The rule with scalar knobs: argmax when temperature <= 0 (noise
    unused), else `_next_token_lanes` with every row on these knobs.
    logits [..., V], noise like logits → [...] token ids."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    rows = logits.reshape(-1, logits.shape[-1])

    def full(x, dtype):
        return torch.full((rows.shape[0],), x, dtype=dtype,
                          device=logits.device)

    tok = _next_token_lanes(rows, noise.reshape(rows.shape),
                            full(temperature, torch.float32),
                            full(top_k, torch.long),
                            full(top_p, torch.float32))
    return tok.reshape(logits.shape[:-1])


def greedy_generate(model: Model, params, batch, steps: int,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None,
                    top_k: int = 0, top_p: float = 0.0, device="cuda"):
    """Prefill + `steps` decode steps, one call per token →
    (tokens [B, steps], final state). tokens[:, 0] is the argmax of the
    prefill logits; each later token follows `_next_token`, with noise
    from `generator` (a generator seeded 0 on the model's device when
    sampling and none is given). `batch` goes to `Model.prefill` whole:
    its `length`, a frontend model's `<frontend>_embed` and an enc-dec
    model's `enc_embed` with it."""
    _check_device(model, device)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    logits, state = model.prefill(params, batch)
    toks = []
    tok = torch.argmax(logits, -1)
    for _ in range(steps):
        toks.append(tok)
        logits, state = model.decode_step(params, state, tok)
        noise = None
        if temperature > 0:
            noise = gumbel_noise([generator] * logits.shape[0],
                                 logits.shape[-1], model.device)
        tok = _next_token(logits, noise, temperature, top_k, top_p)
    return torch.stack(toks, dim=1), state


def decode_block(model: Model, params, state, tok: torch.Tensor, steps: int):
    """`steps` greedy decode steps from token `tok` [B] →
    (state, next_tok [B], toks [steps, B]) with toks[0] == tok. The state
    is any family's, an enc-dec model's cross K/V included."""
    toks = []
    for _ in range(steps):
        toks.append(tok)
        logits, state = model.decode_step(params, state, tok)
        tok = torch.argmax(logits, -1)
    return state, tok, torch.stack(toks)


def decode_block_lanes(model: Model, params, state, tok: torch.Tensor,
                       active: torch.Tensor, rem: torch.Tensor,
                       eos: Union[int, torch.Tensor],
                       gens: Sequence[torch.Generator],
                       temperature: np.ndarray, top_k: np.ndarray,
                       top_p: np.ndarray, steps: int = 1,
                       fault: Optional[np.ndarray] = None):
    """`steps` decode steps with per-lane termination and per-lane
    sampling knobs — the engine's decode block.

    tok [B] long, active [B] bool, rem [B] int: device tensors. Each step
    emits the carried token of every live lane (active, budget left, and
    not its stop token), then advances; a lane deactivates on its stop
    token or its budget, and from then on its cache rows stay frozen. The
    stop token is a signal, never an output. `eos` is one id for every
    lane or a [B] tensor (ids are >= 0, so -1 never matches).
    `temperature`/`top_k`/`top_p` are [B] host arrays with
    `_next_token_lanes` semantics; `gens` holds the B per-lane PRNG
    carries.

    When no lane samples (decided once on the host from `temperature`)
    each step takes the argmax: no knob reaches the card and no generator
    is drawn from. When any lane samples, every lane's generator is drawn
    from once per step, so a lane's sampled stream is a function of (its
    seed, steps resident) alone — independent of its neighbours, its lane
    index and any preempt/resume boundary. No host sync inside the block.

    Non-finite sentinel: every step checks each active lane's logits for
    NaN/Inf; a poisoned lane is deactivated on the device BEFORE it emits
    that step's carried token (the reference's order), so nothing it
    emits comes from corrupt logits, and the host quarantines it. The
    check and the deactivation run every step with no branch: the
    reference's `lax.cond(any(bad))` has no eager counterpart without a
    host sync, and `active & ok` is a bitwise no-op on clean lanes (a NaN
    never crosses the lane axis). `fault` (optional [steps, B] bool host
    array) overwrites the masked lanes' logits with NaN before the check —
    the injection point of `runtime/chaos.py`; it goes to the card in one
    copy a block that does not wait for it. The clean path passes None
    and adds no op: eager PyTorch has no compiled program to share, so the
    reference's always-passed all-False mask has no use here.

    Returns (state, tok, active, rem, finite [B], toks [steps, B],
    emitted [steps, B]); `finite` is False for a lane that was active at
    a step whose logits were not all finite (a poisoned lane)."""
    dev = tok.device
    sampled_any = bool((np.asarray(temperature) > 0).any())
    if sampled_any:
        # one copy that does not wait for the card (a pageable source is
        # staged before the call returns); top_k is exact in f32
        knobs = torch.as_tensor(np.stack([temperature, top_k, top_p]),
                                dtype=torch.float32).to(dev, non_blocking=True)
        t, k, p = knobs[0], knobs[1].long(), knobs[2]
    if fault is not None:
        fault = torch.as_tensor(np.asarray(fault, bool)).to(
            dev, non_blocking=True)
    finite = torch.ones(tok.shape[0], dtype=torch.bool, device=dev)
    toks, emits = [], []
    for i in range(steps):
        logits, state = model.decode_step(params, state, tok, active)
        if fault is not None:
            logits = torch.where(fault[i, :, None], math.nan, logits)
        ok = torch.isfinite(logits).all(dim=-1) | ~active
        finite &= ok
        active = active & ok
        emit = active & (rem > 0) & (tok != eos)
        rem = rem - emit.to(rem.dtype)
        toks.append(tok)
        emits.append(emit)
        active = emit & (rem > 0)
        if sampled_any:
            tok = _next_token_lanes(
                logits, gumbel_noise(gens, logits.shape[-1], dev), t, k, p)
        else:
            tok = torch.argmax(logits, -1)
    return (state, tok, active, rem, finite, torch.stack(toks),
            torch.stack(emits))


def decode_block_lanes_sharded(models: Sequence[Model], params: Sequence,
                               states: Sequence, toks: Sequence[torch.Tensor],
                               active: np.ndarray, rem: np.ndarray,
                               eos: Union[int, np.ndarray],
                               gens: Sequence[torch.Generator],
                               temperature: np.ndarray, top_k: np.ndarray,
                               top_p: np.ndarray, steps: int = 1,
                               fault: Optional[np.ndarray] = None):
    """`decode_block_lanes` over a lane batch split into shards.

    Shard i owns the contiguous lanes [i·n, (i+1)·n) (n = lanes / shards):
    `models[i]`, `params[i]`, `states[i]` and `toks[i]` live on its device,
    and every [lanes] host array (`active`, `rem`, `eos` when per-lane,
    the knobs, the generators, the [steps, lanes] `fault` mask's columns)
    is cut to its lanes. Lanes are independent — attention, sampling and
    the stop and budget masks never read across the lane axis — so each
    shard runs the block on its own lanes alone and nothing crosses
    shards. Every shard's block is dispatched before any is read, so the
    shards' devices overlap; on one card they run in turn.

    Returns (states, toks, active [lanes], rem [lanes], finite [lanes],
    toks [steps, lanes], emitted [steps, lanes]), the per-lane outputs on
    the host."""
    shards = len(states)
    n = len(active) // shards
    outs = []
    for i in range(shards):
        cut = slice(i * n, (i + 1) * n)
        dev = toks[i].device
        e = eos if np.isscalar(eos) else torch.as_tensor(eos[cut],
                                                         device=dev)
        outs.append(decode_block_lanes(
            models[i], params[i], states[i], toks[i],
            torch.as_tensor(active[cut], device=dev),
            torch.as_tensor(rem[cut], device=dev), e, gens[cut],
            temperature[cut], top_k[cut], top_p[cut], steps=steps,
            fault=(None if fault is None or not fault[:, cut].any()
                   else fault[:, cut])))
    host = [[x.cpu().numpy() for x in o[2:]] for o in outs]
    cat = [np.concatenate(parts, axis=-1) for parts in zip(*host)]
    return ([o[0] for o in outs], [o[1] for o in outs], *cat)


# ---------------------------------------------------------------------------
# Requests + per-request serving metrics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling override (the loop-level `temperature`/
    `top_k`/`top_p` knobs, plus an optional per-request stop token `eos`).
    Honoured across the request's whole stream: the admission-seeded first
    token and every decode step. A request carrying one is admitted solo
    (its seeding draw is its own), then decodes mixed with everyone
    else."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos: Optional[int] = None        # None → the loop's eos


@dataclasses.dataclass(eq=False, kw_only=True)
class Request:
    """One generation request (keyword-only; `submit()` assigns `rid`).

    `arrival` is seconds from `run()` start (0 = already waiting).
    `sampling` overrides the loop's sampling knobs for this request's
    whole stream; `sample_seed` pins its PRNG stream (both force a solo
    admission, but decode runs mixed). `priority` (higher = more urgent,
    default 0) picks the scheduling class: higher classes are admitted
    first and may PREEMPT the lowest-priority active lane when no lane is
    free (the victim's state is captured and it resumes token-identical
    later). `reuse_prefix=False` opts out of the prefix cache both ways.
    `deadline_s` is a completion deadline in seconds from arrival: a
    request still waiting or still decoding when it expires resolves with
    outcome "deadline" (partial tokens kept; its lane frees at the next
    block boundary). `RequestHandle.cancel()` resolves the same way with
    outcome "cancelled".
    Identity-compared (eq=False): the scheduler removes requests from its
    queues by identity."""
    prompt: np.ndarray
    max_new: Optional[int] = None        # None → the loop's default
    arrival: float = 0.0
    sample_seed: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    priority: int = 0
    reuse_prefix: bool = True            # consult + feed the prefix cache
    deadline_s: Optional[float] = None   # completion deadline from arrival
    # engine-assigned fields — never pass these to the constructor
    rid: int = -1
    bucket: int = 0            # memoized pad width under the loop's grid
    admitted: bool = False     # lazy-prune marker for the arrival deque
    resume: Optional["_ResumeState"] = None   # set while preempted
    cancelled: bool = False    # set by RequestHandle.cancel()
    retries: int = 0           # quarantine retries consumed so far
    # the lane generator's seed, memoized at the first sampled admission
    # so a quarantine retry replays the same stream without drawing from
    # the loop's stream again (see `_seed_keys`)
    seed_keys: Optional[int] = None


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

    @property
    def outcome(self) -> Optional[str]:
        """Terminal outcome — "done" | "cancelled" | "deadline" |
        "rejected" | "failed" — or None while the request is live."""
        return self.stats.outcome if self.done else None

    def cancel(self) -> bool:
        """Ask for cancellation → True if the request was still live (it
        resolves "cancelled" at the next scheduler round; a decoding lane
        frees at the next block boundary), False if it had already
        ended."""
        return self._loop.cancel(self.rid)

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
    admit_seq: int = -1        # admission order (0 = admitted first)
    group_size: int = 1        # requests sharing this admission dispatch
    prefix_tokens: int = 0     # prompt tokens served from the prefix cache
    prefix_exact: bool = False  # whole prompt hit (state splice, no prefill)
    priority: int = 0          # scheduling class (higher = more urgent)
    preemptions: int = 0       # times this request was evicted + requeued
    outcome: str = "done"      # done|cancelled|deadline|rejected|failed
    detail: str = ""           # the reason for an outcome other than done
    retries: int = 0           # quarantine retries this request consumed
    retry_after: float = 0.0   # suggested resubmit delay (backpressure)
    degraded: bool = False     # admitted under a degraded budget cap

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_arrival

    @property
    def decode_tps(self) -> float:
        return len(self.tokens) / max(self.t_done - self.t_admit, 1e-9)


@dataclasses.dataclass
class _ResumeState:
    """One preempted lane, captured exact to the token: the batch-1
    DecodeState (`state_lane_slice`, a copy the lane's next occupant
    cannot overwrite), the carried not-yet-emitted next token, the unspent
    budget, the lane's PRNG carry (`torch.Generator.get_state()`) and the
    tokens emitted so far. `_admit_resumed` splices it back with no
    prefill; because the block draws from a lane's generator once per
    resident step, the resumed stream equals an uninterrupted one —
    greedy and seeded-sampled lanes alike."""
    state: DecodeState         # batch-1, on the model's device
    tok: int                   # next token to emit (block carry)
    rem: int                   # unspent budget
    key: torch.Tensor          # the lane generator's state (host bytes)
    outputs: List[int]         # tokens emitted before the eviction


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
        h2 = loop.submit(Request(prompt=p2, max_new=16, sample_seed=7,
                                 sampling=SamplingParams(temperature=0.7)))
        stats = loop.run()                    # List[RequestStats]
        h.done, h.tokens

    Scheduling follows the reference. Arrived requests wait in per-class
    FIFO deques keyed by `(-priority, bucket)`; at each admission point
    the group is up to the free lanes' count of one class: the FIFO head's
    off load (unless a higher class waits), the best class's shortest
    bucket under load, and the head's once it has been passed over
    `max_head_skips` rounds in a row. A request with its own sampling
    knobs or seed, or a preempted one resuming, is admitted solo. A group
    is prefilled at exactly its size (eager PyTorch compiles nothing, so
    the reference's power-of-two row padding has no use here). With no
    free lane, a waiting class strictly above the lowest-priority active
    lane preempts that lane (`_try_preempt`); otherwise `_reserve` pops
    the requests predicted (`predicted_free_blocks`) to find a lane within
    `reserve_blocks` decode blocks, and they are admitted first once the
    lanes free. `counters` tracks `prefill_dispatches`,
    `admit_dispatches`, `grouped_admissions`, `grouped_requests`,
    `chunk_dispatches`, `decode_blocks`, `decode_steps`,
    `nonfinite_lanes` (admissions or active lanes whose logits were not
    finite), `preemptions`, `reservations`, `reserved_admits` and
    `preempt_cache_inserts`.

    Sampling (`temperature`, `top_k`, `top_p`; `_next_token_lanes`):
    the loop's knobs are per-lane defaults; a request's `SamplingParams`
    rides its lane for the whole stream, the first token included, and
    its `eos` stops that lane alone. Each lane carries its own
    `torch.Generator` on the model's device, seeded at a sampled admission
    from `sample_seed` or from a draw of the loop's CPU generator (seeded
    with the loop's `sample_seed`; drawn only when the request samples).
    The first token's noise and every later step's come from that one
    stream. Streams are per device: the CPU's and the card's differ, and
    neither is jax's. A block in which no lane samples takes the argmax
    and draws nothing. The reference's `decode_block_programs` and
    `decode_windows` counters are left out: eager PyTorch compiles no
    block program, and the port has no decode window.

    Chunked admission (`chunk_prefill=C`): a prompt whose bucket exceeds C
    reserves a free lane and is prefilled in C-token slices
    (`Model.prefill_chunk`, then `prefill_finalize`) over a workspace of
    the bucket rounded up to a multiple of C; only the chunks that hold
    real tokens run. Each round of `run()` schedules, runs one slice, then
    one decode block, so live lanes keep decoding while a long prompt
    prefills. At most one sliced prefill is in flight; while one is, a
    round whose target needs slicing admits the shortest bucket that does
    not instead. `RequestStats.prefill_chunks` counts a request's slices.

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
    `cfg.attn_chunk` (the same column-sum order), and so does a preempted
    lane whose captured prompt prefix is still slot-aligned. Grouped
    admissions of two or more neither look up nor insert.
    `Request(reuse_prefix=False)` opts out. Counters: `prefix_lookups`,
    `prefix_hits`, `prefix_exact_hits`, `prefix_copies`,
    `prefix_tokens_reused`, `prefix_inserts`, `prefix_evictions`;
    `prefix_host_s` holds the host seconds of the trie's snapshot copies
    (`insert_s`) and of exact-hit splices (`splice_s`).

    Fault tolerance follows the reference. `Request(deadline_s=...)` and
    `RequestHandle.cancel()` end a waiting request when it is popped
    (`_resolve_dead`) and a decoding one at the next round
    (`_sweep_lanes`: the lane's host active flag clears, so the next
    block's device mask drops its writes; partial tokens kept). The
    decode block's sentinel deactivates a lane whose logits are not
    finite; `_quarantine_lane` frees it, drops its partial tokens and
    requeues the request at its arrival rank, which replays token-
    identical (a re-prefill, and the seed memoized on the request), up to
    `max_retries` times, then resolves "failed" with the clean prefix.
    `max_queue > 0` bounds the waiting population: a submit that
    overflows it sheds the latest waiter of a strictly lower class, or is
    itself rejected, with a `retry_after` hint from the measured block
    wall. Unservable submits (empty prompt, `max_new <= 0`, a prompt
    longer than a pinned grid) are rejected at once. `degrade` ("auto" or
    a tuple of {"block", "max_new_cap"} levels) steps down one level a
    round while every lane is busy, at least `degrade_high` wait and no
    lane frees within the reservation horizon, and back up once at most
    `degrade_low` wait; a smaller block only shortens the dispatch (the
    port has no decode window), so token values never change. `chaos`
    attaches a `ChaosConfig` (NaN logits, stalls, blackouts). `run()`
    resolves waiting work it cannot place (`_fail_stuck`). Counters:
    `deadline_expired`, `cancelled_requests`, `rejected_requests`,
    `shed_requests`, `quarantined_lanes`, `retried_requests`,
    `failed_requests`, `degrade_down`, `degrade_up`, `chaos_faults`,
    `chaos_stalls`, `chaos_blackouts`.

    Lane sharding (`mesh=n` or a `launch.mesh.LaneMesh`): `lanes` must
    divide into `shards` blocks of `lanes_per_shard` contiguous lanes, and
    shard i keeps its own `DecodeState`, carried tokens and generators on
    `mesh.devices[i]` (`shard_states`, `shard_toks`); the params are copied
    once per distinct device. Each decode block runs `decode_block_lanes`
    once per shard (`decode_block_lanes_sharded`); nothing reads across
    shards, and per-lane arithmetic does not depend on the other lanes, so
    the streams are the unsharded loop's. Admission fills one shard a
    round, the one with the most free lanes (`shard_free_lanes`, lowest
    index on ties): a grouped prefill runs on that shard's device and
    splices into its state only; a preempted lane's capture resumes on
    whichever shard frees a lane; a chaos blackout hides its shard's free
    lanes. `aggregate()` adds `shards`, `shard{i}_tokens`, `shard{i}_tok_s`
    and `tokens_per_dispatch`.
    """

    def __init__(self, model: Model, params, lanes: int, max_new: int = 64,
                 eos: int = -1, block: int = 1,
                 buckets: Union[str, Sequence[int], None] = "auto",
                 chunk_prefill: int = 0, group_admit: bool = True,
                 max_head_skips: int = 8, reserve_blocks: int = 1,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, sample_seed: int = 0,
                 prefix_cache_bytes: int = 0, max_retries: int = 2,
                 max_queue: int = 0,
                 degrade: Union[str, Sequence[Dict[str, int]], None] = None,
                 degrade_high: int = 0, degrade_low: int = 0,
                 chaos: Optional[ChaosConfig] = None, mesh=None,
                 device="cuda"):
        _check_device(model, device)
        if model.cfg.frontend != "none":
            what = ("an enc-dec model takes its encoder's frames "
                    "(enc_embed)" if model.cfg.family == "encdec" else
                    f"a {model.cfg.frontend}-frontend model takes its "
                    "embeddings")
            raise ValueError(
                f"{model.cfg.name}: ServeLoop admits token prompts; {what} "
                "through Model.prefill / greedy_generate")
        self.model = model
        self.params = params
        self.lanes = lanes
        # lane sharding: `mesh` is a LaneMesh (or a shard count, for
        # `make_serve_mesh`); shard i owns lanes [i·n, (i+1)·n) on
        # mesh.devices[i]
        if isinstance(mesh, int):
            mesh = make_serve_mesh(mesh, device=model.device)
        self.mesh = mesh
        self.shards = 1
        devices = [model.device]
        if mesh is not None:
            assert list(mesh.shape) == ["data"], (
                f"serve mesh must be 1-D over data: {mesh}")
            self.shards = int(mesh.shape["data"])
            assert lanes % self.shards == 0, (
                f"lanes={lanes} not divisible by {self.shards} shards")
            devices = list(mesh.devices)
        self.lanes_per_shard = lanes // self.shards
        self._shard_tokens = np.zeros(self.shards, np.int64)
        self._shard_dev = [_same_device(d, model.device) for d in devices]
        # one model and one copy of the params per distinct device: shards
        # on the same card share them
        by_dev = {}
        for dev in self._shard_dev:
            if dev not in by_dev:
                by_dev[dev] = ((model, params) if dev == model.device
                               else _model_on(model, params, dev))
        self._shard_model = [by_dev[d][0] for d in self._shard_dev]
        self._shard_params = [by_dev[d][1] for d in self._shard_dev]
        self.max_new = max_new
        self.eos = eos
        self.block = max(1, block)
        self.buckets = (tuple(buckets)
                        if isinstance(buckets, (list, tuple)) else buckets)
        if self.buckets is not None and not model.supports_bucketed_prefill():
            self.buckets = None               # exact-length prefills
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
        # rounds the FIFO head may be passed over under load
        self.max_head_skips = max(0, max_head_skips)
        self._head_skips = 0
        # drain-aware reservation horizon, in decode blocks (0 = off)
        self.reserve_blocks = max(0, reserve_blocks)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._states: List[Optional[DecodeState]] = [None] * self.shards
        self._toks: List[Optional[torch.Tensor]] = [None] * self.shards
        self.active = np.zeros(lanes, bool)
        self.remaining = np.zeros(lanes, np.int32)
        self.outputs: List[List[int]] = [[] for _ in range(lanes)]
        # per-lane knobs: the loop's values are the defaults a request
        # without overrides inherits; the block reads them every dispatch
        self.lane_temp = np.full(lanes, self.temperature, np.float32)
        self.lane_topk = np.full(lanes, self.top_k, np.int32)
        self.lane_topp = np.full(lanes, self.top_p, np.float32)
        self.lane_eos = np.full(lanes, self.eos, np.int64)
        self._lane_prio = np.zeros(lanes, np.int64)
        # the loop's own stream (host) seeds requests without a pinned
        # seed; each lane's carry lives on its shard's device
        self._gen = torch.Generator().manual_seed(sample_seed)
        self._lane_gens = [
            torch.Generator(device=self._shard_dev[self._shard_of(lane)])
            .manual_seed(sample_seed) for lane in range(lanes)]
        # scheduler state: `_arrivals` holds not-yet-arrived requests in
        # arrival order; once arrived they move into their class deque
        # (keyed (-priority, bucket): min() is the highest class, shortest
        # bucket) and onto `_arrived_fifo` (arrival order, admitted
        # entries lazily pruned)
        self._arrivals: Deque[Request] = deque()
        self._bucket_q: Dict[Tuple[int, int], Deque[Request]] = {}
        self._arrived_fifo: Deque[Request] = deque()
        self._arrived_count = 0
        self._reserved: Deque[Request] = deque()   # drain-aware pre-group
        self._req_by_rid: Dict[int, Request] = {}
        self._drained_hwm = float("-inf")     # newest arrival drained
        self.stats: Dict[int, RequestStats] = {}
        self.completed: List[RequestStats] = []
        self._lane_rid: List[Optional[int]] = [None] * lanes
        self._next_rid = 0
        self._t0: Optional[float] = None
        self._finished: set = set()
        self._admit_seq = 0
        # drain-prediction inputs: generated lengths of EOS-terminated
        # requests (globally and per (priority, bucket) class) and the
        # count of budget-exhausted ones
        self._eos_lens: List[int] = []
        self._eos_by_class: Dict[Tuple[int, int], List[int]] = {}
        self._budget_done = 0
        self.counters: Dict[str, int] = {
            "prefill_dispatches": 0, "admit_dispatches": 0,
            "grouped_admissions": 0, "grouped_requests": 0,
            "chunk_dispatches": 0, "decode_blocks": 0, "decode_steps": 0,
            "nonfinite_lanes": 0,
            "preemptions": 0, "reservations": 0, "reserved_admits": 0,
            "prefix_lookups": 0, "prefix_hits": 0, "prefix_exact_hits": 0,
            "prefix_copies": 0, "prefix_tokens_reused": 0,
            "prefix_inserts": 0, "prefix_evictions": 0,
            "preempt_cache_inserts": 0,
            "deadline_expired": 0, "cancelled_requests": 0,
            "rejected_requests": 0, "shed_requests": 0,
            "quarantined_lanes": 0, "retried_requests": 0,
            "failed_requests": 0, "degrade_down": 0, "degrade_up": 0,
            "chaos_faults": 0, "chaos_stalls": 0, "chaos_blackouts": 0,
        }
        # -- fault tolerance --------------------------------------------------
        self.max_retries = max(0, max_retries)
        self.max_queue = max(0, max_queue)     # 0 = unbounded
        if degrade == "auto":
            degrade = ({"block": max(1, self.block // 2)},
                       {"block": max(1, self.block // 4),
                        "max_new_cap": 4 * self.block})
        self.degrade_ladder: Tuple[Dict[str, int], ...] = (
            tuple(degrade) if degrade else ())
        # hysteresis on the waiting population: down at >= high with every
        # lane busy, back up at <= low
        self.degrade_high = degrade_high if degrade_high > 0 else 2 * lanes
        self.degrade_low = max(0, degrade_low)
        self._degrade_level = 0
        self.chaos = chaos
        self._rounds = 0                       # run() iterations
        self._blackout_on = False
        self._block_s_ema: Optional[float] = None   # wall s a decode block

    # -- shards --------------------------------------------------------------

    @property
    def state(self) -> Optional[DecodeState]:
        """The decode state of a one-shard loop (`shard_states` holds a
        sharded loop's, one a shard)."""
        if self.shards != 1:
            raise AttributeError("a sharded ServeLoop keeps one state a "
                                 "shard: see shard_states")
        return self._states[0]

    @property
    def tok(self) -> Optional[torch.Tensor]:
        """The carried next token of every lane of a one-shard loop."""
        if self.shards != 1:
            raise AttributeError("a sharded ServeLoop keeps one token "
                                 "tensor a shard: see shard_toks")
        return self._toks[0]

    @property
    def shard_states(self) -> List[Optional[DecodeState]]:
        return list(self._states)

    @property
    def shard_toks(self) -> List[Optional[torch.Tensor]]:
        return list(self._toks)

    def _shard_of(self, lane: int) -> int:
        """Shard owning `lane`: each shard holds a contiguous block of
        lanes_per_shard lanes."""
        return lane // self.lanes_per_shard

    def _local(self, lane: int) -> Tuple[int, int]:
        """(shard, the lane's row in that shard's state)."""
        return lane // self.lanes_per_shard, lane % self.lanes_per_shard

    def shard_free_lanes(self) -> List[List[int]]:
        """Free lanes grouped by shard — the scheduler's shard-local
        admission view. A lane is free without a request; a sliced
        prefill's reserved lane is not. A chaos blackout hides its shard's
        free lanes while it lasts (resident lanes keep decoding) and counts
        once an interval; rounds keep ticking, so it expires. Without a
        mesh this is one list."""
        reserved = None if self._pending is None else self._pending.lane
        free: List[List[int]] = [[] for _ in range(self.shards)]
        for i in range(self.lanes):
            if self._lane_rid[i] is None and i != reserved:
                free[self._shard_of(i)].append(i)
        black = False
        if self.chaos is not None and self.chaos.blackout_shard >= 0:
            for sh in range(self.shards):
                if self.chaos.blacked_out(self._rounds, sh):
                    black = True
                    free[sh] = []
        if black and not self._blackout_on:
            self.counters["chaos_blackouts"] += 1
        self._blackout_on = black
        return free

    def _now(self) -> float:
        return 0.0 if self._t0 is None else time.monotonic() - self._t0

    # -- request intake ------------------------------------------------------

    def submit(self, request: Request) -> RequestHandle:
        """Queue one request → its handle. An unservable request, or one
        that overflows `max_queue` without a lower class to shed, comes
        back already resolved "rejected"."""
        if not isinstance(request, Request):
            raise TypeError("submit() takes a Request(prompt=..., max_new=...)")
        if request.rid >= 0:
            raise ValueError(f"Request already submitted (rid={request.rid})")
        req = request
        req.prompt = np.asarray(req.prompt)
        if req.max_new is None:
            req.max_new = self.max_new
        req.rid = self._next_rid
        self._next_rid += 1
        self._req_by_rid[req.rid] = req
        reason = self._unadmittable(req)
        if reason is not None:
            return self._reject_new(req, reason)
        if self.max_queue and self._waiting_count() >= self.max_queue:
            victim = self._shed_candidate(req)
            if victim is None:
                return self._reject_new(req, "queue full", backpressure=True)
            self._shed(victim)
        req.bucket = self._bucket_of(req)
        arrival = float(req.arrival)
        if arrival < self._drained_hwm:
            # backdated submit among already-drained requests: splice it
            # into the arrived structures at its arrival rank
            self._insert_arrived(req)
        elif self._arrivals and arrival < self._arrivals[-1].arrival:
            # keep arrival order (FIFO among ties) — the drain pops head
            idx = next(i for i, r in enumerate(self._arrivals)
                       if r.arrival > arrival)
            self._arrivals.insert(idx, req)
        else:
            self._arrivals.append(req)
        self.stats[req.rid] = RequestStats(req.rid, len(req.prompt),
                                           req.max_new, t_arrival=arrival,
                                           priority=req.priority)
        return RequestHandle(self, req.rid)

    # -- structured rejection + backpressure -----------------------------------

    def _unadmittable(self, req: Request) -> Optional[str]:
        """Why this request can never be served (it is rejected at submit
        instead of wedging `run()`), or None."""
        if len(req.prompt) == 0:
            return "empty prompt"
        if req.max_new <= 0:
            return "max_new <= 0 generates nothing"
        if (isinstance(self.buckets, tuple) and self.buckets
                and len(req.prompt) > max(self.buckets)):
            return (f"prompt length {len(req.prompt)} exceeds every "
                    f"bucket of the pinned grid {self.buckets}")
        return None

    def _waiting_count(self) -> int:
        """The waiting population `max_queue` bounds: arrived and not
        admitted, future arrivals and reserved requests."""
        return (self._arrived_count + len(self._arrivals)
                + len(self._reserved))

    def _retry_after(self) -> float:
        """Suggested resubmit delay for a backpressure rejection: the
        waiting population's predicted drain time at the measured wall
        time a decode block (0.05 s before the first block)."""
        blk = self._block_s_ema if self._block_s_ema is not None else 0.05
        depth = self._waiting_count() / max(self.lanes, 1)
        tokens = np.mean([r.max_new for r in self._arrived_fifo
                          if not r.admitted] or [self.max_new])
        return depth * math.ceil(float(tokens) / self.block) * blk

    def _finish_queued(self, req: Request, outcome: str,
                       detail: str = "") -> None:
        """Resolve a request that holds no lane with a terminal outcome
        (a preempted one keeps its partial tokens)."""
        st = self.stats[req.rid]
        now = self._now()
        if req.resume is not None:
            st.tokens = list(req.resume.outputs)
            req.resume = None
        st.outcome = outcome
        st.detail = detail
        st.t_done = max(now, st.t_arrival)
        if st.t_first < st.t_admit:
            st.t_first = st.t_done
        req.admitted = True                    # lazy-prune marker
        self.completed.append(st)
        self._finished.add(req.rid)
        self._req_by_rid.pop(req.rid, None)

    def _reject_new(self, req: Request, reason: str,
                    backpressure: bool = False) -> RequestHandle:
        """Resolve a just-submitted request "rejected" without queueing it;
        under backpressure its `retry_after` says when to resubmit."""
        self.stats[req.rid] = RequestStats(
            req.rid, len(req.prompt), max(req.max_new, 0),
            t_arrival=float(req.arrival), priority=req.priority)
        self.counters["rejected_requests"] += 1
        self._finish_queued(req, "rejected", reason)
        if backpressure:
            self.stats[req.rid].retry_after = self._retry_after()
        return RequestHandle(self, req.rid)

    def _shed_candidate(self, new: Request) -> Optional[Request]:
        """The latest arrival of the worst waiting class, if that class is
        strictly below `new`'s; else None (then `new` is rejected)."""
        worst: Optional[Request] = None
        if self._bucket_q:
            worst = self._bucket_q[max(self._bucket_q)][-1]
        for r in self._arrivals:
            if worst is None or r.priority < worst.priority or (
                    r.priority == worst.priority
                    and r.arrival >= worst.arrival):
                worst = r
        if worst is None or worst.priority >= new.priority:
            return None
        return worst

    def _shed(self, victim: Request) -> None:
        """Drop one waiting request to make room ("rejected", counted as
        shed; its handle stays valid)."""
        if victim in self._arrivals:           # identity compare (eq=False)
            self._arrivals.remove(victim)
        else:
            key = self._qkey(victim)
            dq = self._bucket_q[key]
            dq.remove(victim)
            if not dq:
                del self._bucket_q[key]
            self._arrived_count -= 1
        self.counters["shed_requests"] += 1
        self.counters["rejected_requests"] += 1
        self._finish_queued(victim, "rejected", "shed under backpressure")
        self.stats[victim.rid].retry_after = self._retry_after()

    # -- cancellation + deadlines ----------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Flag one request for cancellation (see RequestHandle.cancel)."""
        req = self._req_by_rid.get(rid)
        if rid in self._finished or req is None:
            return False
        req.cancelled = True
        return True

    def _deadline_over(self, req: Request, now: float) -> bool:
        return (req.deadline_s is not None
                and now >= self.stats[req.rid].t_arrival + req.deadline_s)

    def _resolve_dead(self, req: Request) -> bool:
        """Resolve a waiting request that was cancelled or whose deadline
        passed → whether it is gone (then it is not admitted). Called where
        a request leaves a queue, so no round scans the backlog."""
        if req.cancelled:
            self.counters["cancelled_requests"] += 1
            self._finish_queued(req, "cancelled")
            return True
        if self._deadline_over(req, self._now()):
            self.counters["deadline_expired"] += 1
            self._finish_queued(req, "deadline",
                                f"deadline_s={req.deadline_s} expired "
                                "before admission")
            return True
        return False

    def _sweep_lanes(self, now: float) -> None:
        """End the active lanes whose request was cancelled or passed its
        deadline: clear the host active flag (the next block's device
        mask drops their writes) and finish them with their partial
        tokens. Runs every round, so such a lane frees within one block."""
        for lane in np.flatnonzero(self.active):
            lane = int(lane)
            req = self._req_by_rid[self._lane_rid[lane]]
            if req.cancelled:
                self.counters["cancelled_requests"] += 1
                outcome, detail = "cancelled", ""
            elif self._deadline_over(req, now):
                self.counters["deadline_expired"] += 1
                outcome = "deadline"
                detail = f"deadline_s={req.deadline_s} expired mid-decode"
            else:
                continue
            self.active[lane] = False
            self.remaining[lane] = 0
            self._finish_lane(lane, now, outcome=outcome, detail=detail)

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

    # -- scheduler queues ------------------------------------------------------

    def _qkey(self, req: Request) -> Tuple[int, int]:
        """Scheduling-class deque key: sorts as (-priority, bucket)."""
        return (-req.priority, req.bucket)

    def _insert_arrived(self, req: Request) -> None:
        """Insert at arrival rank (after ties) into the arrived deques."""
        def rank(dq):
            return next((i for i, r in enumerate(dq)
                         if r.arrival > req.arrival), len(dq))
        self._arrived_fifo.insert(rank(self._arrived_fifo), req)
        dq = self._bucket_q.setdefault(self._qkey(req), deque())
        dq.insert(rank(dq), req)
        self._arrived_count += 1

    @property
    def queue(self) -> List[Request]:
        """Waiting (un-admitted) requests in arrival order — arrived first,
        then future arrivals (a snapshot)."""
        waiting = [r for r in self._arrived_fifo if not r.admitted]
        return waiting + list(self._arrivals)

    def _drain_arrivals(self, now: float) -> None:
        """Move every request whose arrival time has passed into its class
        deque (each request moves once)."""
        while self._arrivals and self._arrivals[0].arrival <= now:
            req = self._arrivals.popleft()
            self._bucket_q.setdefault(self._qkey(req), deque()).append(req)
            self._arrived_fifo.append(req)
            self._arrived_count += 1
            self._drained_hwm = max(self._drained_hwm, req.arrival)

    def _fifo_head(self) -> Optional[Request]:
        """Oldest arrived, un-admitted request (lazy-pruned deque head)."""
        fifo = self._arrived_fifo
        while fifo and fifo[0].admitted:
            fifo.popleft()
        return fifo[0] if fifo else None

    @staticmethod
    def _needs_solo(req: Request) -> bool:
        """A request with its own sampling knobs or seed seeds its first
        token from its own stream, and a preempted one splices its
        captured state: either is admitted alone (it decodes mixed)."""
        return (req.sampling is not None or req.sample_seed is not None
                or req.resume is not None)

    def _take_bucket(self, key: Tuple[int, int], n: int) -> List[Request]:
        """Pop up to `n` FIFO requests from one class deque; a request
        that needs a solo admission ends (or alone forms) the group."""
        dq = self._bucket_q.get(key)
        group: List[Request] = []
        while dq and len(group) < n:
            if group and self._needs_solo(dq[0]):
                break
            req = dq.popleft()
            req.admitted = True
            group.append(req)
            if self._needs_solo(req):
                break
        if dq is not None and not dq:
            del self._bucket_q[key]
        self._arrived_count -= len(group)
        return group

    def _take_reserved(self, n: int) -> List[Request]:
        """Pop a same-bucket prefix of the reservation queue (<= n), with
        the solo boundaries of `_take_bucket`."""
        rq = self._reserved
        group: List[Request] = []
        while rq and len(group) < n:
            if group and (self._needs_solo(rq[0])
                          or rq[0].bucket != group[0].bucket):
                break
            req = rq.popleft()
            group.append(req)
            if self._needs_solo(req):
                break
        return group

    # -- scheduling ----------------------------------------------------------

    def _free_lanes(self) -> List[int]:
        """The free lanes of the shard admission fills next: the one with
        the most free lanes, the lowest index on ties (empty when no shard
        has one)."""
        return max(self.shard_free_lanes(), key=len)

    def _blackout_active(self) -> bool:
        return (self.chaos is not None and self.chaos.blackout_shard >= 0
                and any(self.chaos.blacked_out(self._rounds, sh)
                        for sh in range(self.shards)))

    def _needs_chunking(self, bucket: int) -> bool:
        return 0 < self.chunk_prefill < bucket

    def schedule(self) -> int:
        """Admit arrived requests into free lanes, one class group per
        round, until no lane or no arrived request is left → admitted (a
        sliced prefill counts once it has been opened).

        The target is the FIFO head's class off load (unless a strictly
        higher class waits), the best (-priority, bucket) class under load
        (more arrived requests than free lanes), and the head's class once
        it has been passed over `max_head_skips` rounds. Reserved requests
        go first. A preempted request resumes by a solo state splice. At
        most one sliced prefill is in flight; while one is, a target that
        needs slicing gives way to the shortest class that does not. With
        no free lane: `_try_preempt`, else `_reserve`."""
        n = 0
        while True:
            self._drain_arrivals(self._now())
            if self._arrived_count == 0 and not self._reserved:
                return n
            free = self._free_lanes()
            if not free:
                if self._try_preempt():
                    continue
                self._reserve()
                return n
            if self._reserved:
                group = self._take_reserved(len(free))
                self.counters["reserved_admits"] += len(group)
                n += self._admit_chosen(free, group)
                continue
            fifo_head = self._fifo_head()      # arrived_count > 0: set
            if not self.group_admit:
                target, take = self._qkey(fifo_head), 1
            else:
                best = min(self._bucket_q)
                if self._arrived_count > len(free):
                    target = best
                    if (-best[0] <= fifo_head.priority
                            and target != self._qkey(fifo_head)
                            and self._head_skips >= self.max_head_skips):
                        target = self._qkey(fifo_head)   # aging
                else:
                    target = self._qkey(fifo_head)
                    if -best[0] > fifo_head.priority:
                        target = best
                take = len(free)
            if self._bucket_q[target][0].resume is not None:
                req = self._take_bucket(target, 1)[0]
                if self._resolve_dead(req):
                    continue
                self._head_skips = (0 if fifo_head is req
                                    else self._head_skips + 1)
                self._admit_resumed(free[0], req)
                n += 1
                continue
            if (self.group_admit and self._pending is not None
                    and self._needs_chunking(target[1])):
                # one sliced prefill at a time: admit the shortest class
                # that needs no slicing instead of idling the free lanes
                alts = [k for k in self._bucket_q
                        if not self._needs_chunking(k[1])
                        or self._bucket_q[k][0].resume is not None]
                if not alts:
                    return n
                target = min(alts)
                if self._bucket_q[target][0].resume is not None:
                    req = self._take_bucket(target, 1)[0]
                    if self._resolve_dead(req):
                        continue
                    self._admit_resumed(free[0], req)
                    n += 1
                    continue
            if self._needs_chunking(target[1]):
                if self._pending is not None:
                    return n
                head = self._take_bucket(target, 1)[0]
                if self._resolve_dead(head):
                    continue
                self._head_skips = (0 if fifo_head is head
                                    else self._head_skips + 1)
                self._start_chunked(free[0], head)
                n += 1
                continue
            group = self._take_bucket(target, take)
            self._head_skips = (0 if fifo_head in group
                                else self._head_skips + 1)
            n += self._admit_chosen(free, group)

    def _admit_chosen(self, free: List[int], group: List[Request]) -> int:
        """Dispatch an already-popped group into free lanes (a resuming
        head splices its captured state). Cancelled or expired members
        resolve here instead: the group shrinks."""
        group = [r for r in group if not self._resolve_dead(r)]
        if not group:
            return 0
        if group[0].resume is not None:
            self._admit_resumed(free[0], group[0])
        elif len(group) == 1:
            self._admit_lane(free[0], group[0])
        else:
            self._admit_group(free[:len(group)], group)
        return len(group)

    # -- admission -------------------------------------------------------------

    def _ensure_state(self) -> None:
        """Every shard's empty state and token tensor, on its device."""
        for sh in range(self.shards):
            if self._states[sh] is None:
                self._states[sh] = self._shard_model[sh].init_decode_state(
                    self.lanes_per_shard)
                self._toks[sh] = torch.zeros(self.lanes_per_shard,
                                             dtype=torch.long,
                                             device=self._shard_dev[sh])

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
        g = len(group)
        rows = np.stack([self._padded_prompt(r) for r in group])
        lengths = np.array([len(r.prompt) for r in group], np.int32)
        # up to a power-of-two row count with copies of row 0, as the
        # reference pads its group programs: a moe block's expert capacity
        # is shared by every row of the pass, so the copies count
        gp = min(1 << (g - 1).bit_length(), self.lanes)
        rows = np.concatenate([rows, np.repeat(rows[:1], gp - g, axis=0)])
        lengths = np.concatenate([lengths, np.repeat(lengths[:1], gp - g)])
        # exact-length rows (buckets=None: a recurrent model, or asked for)
        # need no length mask, and an SSM or hybrid model refuses one
        sh = self._shard_of(lanes[0])
        dev = self._shard_dev[sh]
        logits, fresh = self._shard_model[sh].prefill_group(
            self._shard_params[sh], torch.as_tensor(rows, device=dev),
            None if self.buckets is None
            else torch.as_tensor(lengths, device=dev))
        logits = logits[:g]
        self.counters["prefill_dispatches"] += 1
        if g > 1:
            self.counters["grouped_admissions"] += 1
            self.counters["grouped_requests"] += g
        self._splice(lanes, group, logits, fresh, bucket=len(rows[0]))
        return logits, fresh, len(rows[0])

    def _sample_key(self) -> int:
        """A fresh seed from the loop's own (host) stream."""
        return int(torch.randint(0, 2 ** 62, (), generator=self._gen))

    def _req_sampling(self, req: Request) -> Tuple[float, int, float]:
        """(temperature, top_k, top_p) of this request: its SamplingParams
        override, else the loop's knobs."""
        sp = req.sampling
        if sp is None:
            return self.temperature, self.top_k, self.top_p
        return float(sp.temperature), int(sp.top_k), float(sp.top_p)

    def _seed_keys(self, req: Request, lane: int
                   ) -> Optional[torch.Generator]:
        """Seed `lane`'s generator with the request's stream → that
        generator, or None when the request is greedy (then neither the
        loop's stream nor the lane's carry is touched). A pinned
        `sample_seed` is the seed; otherwise it is drawn from the loop's
        stream. The first token's noise and every later step's come from
        this one stream, so a seeded request's sampled tokens depend only
        on (seed, tokens generated): solo, grouped, on any lane, or across
        a preempt/resume boundary alike. The seed is memoized on the
        request at its first admission, so a quarantine retry replays the
        same stream and does not draw from the loop's stream again (a
        second draw would fork the retry and shift later requests'
        seeds)."""
        if self._req_sampling(req)[0] <= 0:
            return None
        if req.seed_keys is None:
            req.seed_keys = (req.sample_seed if req.sample_seed is not None
                             else self._sample_key())
        return self._lane_gens[lane].manual_seed(req.seed_keys)

    def _first_tokens(self, logits: torch.Tensor, group: List[Request],
                      gens: List[Optional[torch.Generator]]) -> torch.Tensor:
        """Each admitted row's first token through its request's rule: the
        argmax when every row is greedy (no knob reaches the card),
        else `_next_token_lanes` with each sampled row's noise drawn from
        its own stream (greedy rows take no noise)."""
        rows = [i for i, g in enumerate(gens) if g is not None]
        if not rows:
            return torch.argmax(logits, -1)
        dev = logits.device
        noise = torch.zeros(logits.shape, dtype=torch.float32, device=dev)
        noise[rows] = gumbel_noise([gens[i] for i in rows],
                                   logits.shape[-1], dev)
        t, k, p = zip(*(self._req_sampling(r) for r in group))
        return _next_token_lanes(
            logits, noise, torch.tensor(t, dtype=torch.float32, device=dev),
            torch.tensor(k, dtype=torch.long, device=dev),
            torch.tensor(p, dtype=torch.float32, device=dev))

    def _splice(self, lanes: List[int], group: List[Request], logits, fresh,
                bucket: int, prefill_chunks: int = 1,
                prefix_tokens: int = 0) -> None:
        """Insert the prefilled batch-G state into `lanes` (row i into
        lanes[i]); each lane's first token follows its request's rule."""
        self.counters["nonfinite_lanes"] += int(
            (~torch.isfinite(logits).all(dim=-1)).sum())
        sh = self._shard_of(lanes[0])
        rows = [self._local(lane)[1] for lane in lanes]
        assert all(self._shard_of(lane) == sh for lane in lanes), lanes
        src = np.full(self.lanes_per_shard, -1, np.int64)
        src[rows] = np.arange(len(group))
        state_lanes_insert(self._states[sh], src, fresh)
        gens = [self._seed_keys(r, lane) for lane, r in zip(lanes, group)]
        lane_t = torch.as_tensor(rows, dtype=torch.long,
                                 device=self._shard_dev[sh])
        self._toks[sh][lane_t] = self._first_tokens(logits, group, gens)
        self.counters["admit_dispatches"] += 1
        now = self._now()
        for lane, req in zip(lanes, group):
            self._register_admit(lane, req, now, bucket, prefill_chunks,
                                 prefix_tokens, group_size=len(group))

    def _set_lane_knobs(self, lane: int, req: Request) -> None:
        """Load one lane's knobs from the request (its SamplingParams
        override, else the loop's defaults)."""
        t, k, p = self._req_sampling(req)
        self.lane_temp[lane] = t
        self.lane_topk[lane] = k
        self.lane_topp[lane] = p
        sp = req.sampling
        self.lane_eos[lane] = (self.eos if sp is None or sp.eos is None
                               else sp.eos)
        self._lane_prio[lane] = req.priority

    def _reset_lane_knobs(self, lane: int) -> None:
        """Back to the loop's defaults when a lane frees: a stale sampled
        temperature would otherwise keep the block off its argmax-only
        path."""
        self.lane_temp[lane] = self.temperature
        self.lane_topk[lane] = self.top_k
        self.lane_topp[lane] = self.top_p
        self.lane_eos[lane] = self.eos
        self._lane_prio[lane] = 0

    def _register_admit(self, lane: int, req: Request, now: float,
                        bucket: int, prefill_chunks: int,
                        prefix_tokens: int, prefix_exact: bool = False,
                        group_size: int = 1) -> None:
        """Host-side bookkeeping for a request just spliced into `lane`;
        the degrade ladder's budget cap applies here."""
        cap = self._degrade_cap()
        budget = req.max_new if cap is None else min(req.max_new, cap)
        self.active[lane] = True               # submit rejected max_new <= 0
        self.remaining[lane] = budget
        self.outputs[lane] = []
        self._lane_rid[lane] = req.rid
        self._set_lane_knobs(lane, req)
        st = self.stats[req.rid]
        st.lane, st.t_admit, st.bucket = lane, now, bucket
        st.prefill_chunks = prefill_chunks
        st.admit_seq = self._admit_seq
        st.group_size = group_size
        st.prefix_tokens, st.prefix_exact = prefix_tokens, prefix_exact
        st.degraded = st.degraded or budget < req.max_new
        self._admit_seq += 1

    # -- priority preemption + drain-aware reservation -------------------------

    def _admit_resumed(self, lane: int, req: Request) -> None:
        """Splice a preempted request's captured state back into a free
        lane with no prefill; outputs, budget, PRNG carry and the carried
        next token are all restored."""
        self._ensure_state()
        rs = req.resume
        req.resume = None
        sh, row = self._local(lane)
        state_lane_insert(self._states[sh], row, rs.state)
        self._toks[sh][row] = rs.tok
        self.counters["admit_dispatches"] += 1
        self.active[lane] = rs.rem > 0
        self.remaining[lane] = rs.rem
        self.outputs[lane] = list(rs.outputs)
        self._lane_rid[lane] = req.rid
        self._set_lane_knobs(lane, req)
        self._lane_gens[lane].set_state(rs.key)
        st = self.stats[req.rid]
        st.lane = lane
        st.admit_seq = self._admit_seq
        self._admit_seq += 1

    def _preempt_lane(self, lane: int) -> None:
        """Evict one active lane for a higher class: capture its exact
        mid-stream snapshot (state copy, carried next token, budget, PRNG
        carry, emitted tokens) onto the request and requeue it at its
        arrival rank."""
        rid = self._lane_rid[lane]
        req = self._req_by_rid[rid]
        sh, row = self._local(lane)
        fresh = state_lane_slice(self._states[sh], row)
        req.resume = _ResumeState(
            state=fresh, tok=int(self._toks[sh][row]),
            rem=int(self.remaining[lane]),
            key=self._lane_gens[lane].get_state(),
            outputs=list(self.outputs[lane]))
        self.active[lane] = False
        self.remaining[lane] = 0
        self.outputs[lane] = []
        self._lane_rid[lane] = None
        self._reset_lane_knobs(lane)
        st = self.stats[rid]
        st.preemptions += 1
        st.lane = -1
        self.counters["preemptions"] += 1
        self._cache_insert_preempted(req, fresh)
        self._requeue(req)

    def _cache_insert_preempted(self, req: Request,
                                fresh: DecodeState) -> None:
        """A preempted lane's capture also feeds the trie as a rows donor
        while its prompt prefix is still slot-aligned
        (`cache_prefix_rows`), so a sibling prompt can resume its sliced
        prefill from the victim's rows. The gate refuses a capture that has
        decoded (step past the prompt) or a quantized cache; the grid
        conditions are `_cache_insert_finalized`'s."""
        pc = self.prefix_cache
        if pc is None or not req.reuse_prefix:
            return
        c = self.chunk_prefill
        n = len(req.prompt)
        if not (self._rows_reuse and n % c == 0
                and c == self.model.cfg.attn_chunk and fresh.kv is not None):
            return
        t0 = time.perf_counter()
        # the light fields are checked before k/v/acc are copied out
        rows = cache_prefix_rows(fresh.kv, n)
        if rows is not None:
            pc.insert_rows(req.prompt, RowsEntry(n, *rows))
            self.counters["preempt_cache_inserts"] += 1
        self.prefix_host_s["insert_s"] += time.perf_counter() - t0
        self._sync_cache_counters()

    def _requeue(self, req: Request) -> None:
        """Re-insert a preempted request at its arrival rank: it resumes as
        soon as its class is schedulable again, ahead of later arrivals of
        its class."""
        req.admitted = False
        dq = self._bucket_q.setdefault(self._qkey(req), deque())
        idx = next((i for i, r in enumerate(dq)
                    if r.arrival > req.arrival), len(dq))
        dq.insert(idx, req)
        if req not in self._arrived_fifo:      # identity compare (eq=False)
            fifo = self._arrived_fifo
            idx = next((i for i, r in enumerate(fifo)
                        if r.arrival > req.arrival), len(fifo))
            fifo.insert(idx, req)
        self._arrived_count += 1

    def _try_preempt(self) -> bool:
        """With every lane busy: if the best waiting class strictly
        outranks the lowest-priority active lane, evict that lane (ties go
        to the most predicted remaining work) → whether a lane was freed.
        Equal priorities never preempt."""
        if not self._bucket_q:
            return False
        top = min(self._bucket_q)
        head = self._bucket_q[top][0]
        if (head.resume is None and self._needs_chunking(top[1])
                and self._pending is not None):
            return False          # could not be admitted this round anyway
        pred = self.predicted_free_blocks()
        victim: Optional[int] = None
        vrank: Tuple[int, int] = (0, 0)
        for lane in np.flatnonzero(self.active):
            lane = int(lane)
            if self._pending is not None and lane == self._pending.lane:
                continue
            rid = self._lane_rid[lane]
            if rid is None or rid not in self._req_by_rid:
                continue
            rank = (int(self._lane_prio[lane]), -pred.get(lane, 0))
            if victim is None or rank < vrank:
                victim, vrank = lane, rank
        if victim is None or -top[0] <= vrank[0]:
            return False
        self._preempt_lane(victim)
        return True

    def predicted_free_blocks(self) -> Dict[int, int]:
        """Per active lane, the decode blocks until it frees: its unspent
        budget, bounded by an observed mean EOS-termination length (minus
        what it already emitted). The mean is the lane's (priority,
        bucket) class's once that class has 4 EOS completions; below that
        the global mean applies when at least 4 EOS completions were seen
        and no fewer than budget exhaustions."""
        eos_mean = None
        if (len(self._eos_lens) >= 4
                and len(self._eos_lens) >= self._budget_done):
            eos_mean = float(np.mean(self._eos_lens))
        out: Dict[int, int] = {}
        for lane in np.flatnonzero(self.active):
            lane = int(lane)
            exp = int(self.remaining[lane])
            mean = eos_mean
            rid = self._lane_rid[lane]
            st = self.stats.get(rid) if rid is not None else None
            if st is not None:
                cell = self._eos_by_class.get((st.priority, st.bucket))
                if cell is not None and len(cell) >= 4:
                    mean = float(np.mean(cell))
            if mean is not None:
                exp = min(exp, max(1, round(mean)
                                   - len(self.outputs[lane])))
            out[lane] = max(1, math.ceil(exp / self.block))
        return out

    def _reserve(self) -> None:
        """Drain-aware pre-grouping: with every lane busy, pop as many
        queued requests as lanes are predicted to free within
        `reserve_blocks` decode blocks, so their admission fires the moment
        the lanes free. Reserved requests follow the normal target order
        (class, shortest bucket, aging) and go ahead of the queues."""
        if (not self.reserve_blocks or not self.group_admit
                or not self._bucket_q):
            return
        soon = sum(1 for b in self.predicted_free_blocks().values()
                   if b <= self.reserve_blocks)
        room = soon - len(self._reserved)
        if room <= 0:
            return
        fifo_head = self._fifo_head()
        if fifo_head is None:
            return
        target = min(self._bucket_q)
        if (-target[0] <= fifo_head.priority
                and target != self._qkey(fifo_head)
                and self._head_skips >= self.max_head_skips):
            target = self._qkey(fifo_head)     # aging
        if (self._needs_chunking(target[1])
                and self._bucket_q[target][0].resume is None):
            return          # sliced prefills reserve their own lane
        group = self._take_bucket(target, room)
        if not group:
            return
        self._head_skips = (0 if fifo_head in group
                            else self._head_skips + 1)
        self._reserved.extend(group)
        self.counters["reservations"] += len(group)

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
        into `lane` (no prefill dispatch); the cached logits seed its first
        token through the request's rule, so a greedy repeat reproduces the
        original stream."""
        t0 = time.perf_counter()
        sh, row = self._local(lane)
        state_lane_insert(self._states[sh], row, entry.state)
        gens = [self._seed_keys(req, lane)]
        self._toks[sh][row] = self._first_tokens(
            entry.logits.to(self._shard_dev[sh])[None], [req], gens)[0]
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
        (its cache and SSM state, whichever it has) and its logits."""
        return StateEntry(
            length=len(req.prompt), bucket=bucket,
            logits=logits.to("cpu", copy=True),
            state=DecodeState(*(
                None if x is None else x.map(lambda a: a.to("cpu", copy=True))
                for x in (fresh.kv, fresh.ssm))))

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
                and c == self.model.cfg.attn_chunk
                and entry.state.kv is not None):
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

    # -- graceful degradation --------------------------------------------------

    def _effective_block(self) -> int:
        """Decode block size at the current degrade level (the ladder's
        "block"; level 0 = the configured block). A smaller block answers
        deadlines, cancellation and quarantine sooner and amortizes less;
        token values do not change (the block size never enters a lane's
        arithmetic)."""
        if not self._degrade_level:
            return self.block
        lvl = self.degrade_ladder[self._degrade_level - 1]
        return max(1, int(lvl.get("block", self.block)))

    def _degrade_cap(self) -> Optional[int]:
        """Budget cap on new admissions at the current level (the ladder's
        "max_new_cap"; None = uncapped). A capped request ends "done" with
        `stats.degraded`."""
        if not self._degrade_level:
            return None
        cap = self.degrade_ladder[self._degrade_level - 1].get(
            "max_new_cap")
        return int(cap) if cap else None

    def _pressure_tick(self) -> None:
        """One hysteresis step a round: down when every lane is busy, at
        least `degrade_high` wait and no lane is predicted to free within
        the reservation horizon; up when at most `degrade_low` wait."""
        if not self.degrade_ladder:
            return
        waiting = self._arrived_count + len(self._reserved)
        if (waiting >= self.degrade_high
                and self._degrade_level < len(self.degrade_ladder)
                and not self._free_lanes()):
            pred = self.predicted_free_blocks()
            if pred and min(pred.values()) > max(1, self.reserve_blocks):
                self._degrade_level += 1
                self.counters["degrade_down"] += 1
        elif waiting <= self.degrade_low and self._degrade_level:
            self._degrade_level -= 1
            self.counters["degrade_up"] += 1

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
        model = self._shard_model[self._shard_of(lane)]
        if rows is not None:
            pstate = model.resume_prefill_chunk_state(
                rows.k, rows.v, rows.acc, ws)
            base = rows.depth
            self.counters["prefix_copies"] += 1
            self.counters["prefix_tokens_reused"] += base
        else:
            pstate = model.init_prefill_chunk_state(1, ws)
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
        if p.req.cancelled or self._deadline_over(p.req, self._now()):
            # drop the sliced prefill: its reserved lane frees at once and
            # the remaining slices are never dispatched
            self._pending = None
            self._resolve_dead(p.req)
            return False
        c = self.chunk_prefill
        row0 = p.next_chunk * c
        sh = self._shard_of(p.lane)
        model, params = self._shard_model[sh], self._shard_params[sh]
        tok_c = torch.as_tensor(p.padded[None, row0:row0 + c],
                                device=model.device)
        length = torch.as_tensor([len(p.req.prompt)], dtype=torch.int32,
                                 device=model.device)
        p.x_last, p.pstate = model.prefill_chunk(
            params, p.pstate, tok_c, row0, length)
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
            logits, fresh = model.prefill_finalize(
                params, p.pstate, p.x_last, row0, length)
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
        """Decode `steps` = `_effective_block()` steps over every lane
        (`decode_block_lanes`). A lane emits its carried token while
        active; it stops at its stop token (never emitted) or when its
        budget is spent, and from then on its cache rows stay frozen. With
        a `ChaosConfig`, its stall sleeps before the dispatch and its fault
        mask for this block index rides in (only a mask with a set bit is
        passed). Lanes the sentinel flagged are quarantined and their
        requests retried (`_quarantine_lane`), never finished."""
        steps = self._effective_block()
        eos = self.lane_eos
        # one stop token for every lane stays a Python scalar: the greedy
        # block then copies nothing more to the card than before per-lane
        # stop tokens
        eos = int(eos[0]) if (eos == eos[0]).all() else eos
        fault = None
        if self.chaos is not None and self.chaos.any_faults:
            blk = self.counters["decode_blocks"]
            stall = self.chaos.stall(blk)
            if stall > 0:
                self.counters["chaos_stalls"] += 1
                time.sleep(stall)
            mask = self.chaos.fault_mask(blk, steps, self.lanes)
            self.counters["chaos_faults"] += int(mask.sum())
            if mask.any():
                fault = mask
        t_disp = time.monotonic()
        (self._states, self._toks, active, rem, finite, host_toks,
         host_emit) = decode_block_lanes_sharded(
            self._shard_model, self._shard_params, self._states, self._toks,
            self.active, self.remaining, eos, self._lane_gens,
            self.lane_temp, self.lane_topk, self.lane_topp, steps=steps,
            fault=fault)
        self.counters["decode_blocks"] += 1
        self.counters["decode_steps"] += steps
        was_active = self.active.copy()
        self.active = active
        self.remaining = rem.astype(np.int32)
        poison = was_active & ~finite
        # per-shard emission accounting (the host's, the only traffic
        # between shards)
        self._shard_tokens += host_emit.sum(axis=0).reshape(
            self.shards, self.lanes_per_shard).sum(axis=1)
        # the block's wall, the card's work included (the dispatch returns
        # before the card finishes; the copies above wait for it): an EMA
        # feeds the backpressure hint `retry_after`
        dt = time.monotonic() - t_disp
        self._block_s_ema = (dt if self._block_s_ema is None
                             else 0.8 * self._block_s_ema + 0.2 * dt)
        self.counters["nonfinite_lanes"] += int(poison.sum())
        now = self._now()
        for lane in np.flatnonzero(host_emit.any(axis=0)):
            if not self.outputs[lane]:
                self.stats[self._lane_rid[lane]].t_first = now
            self.outputs[lane].extend(
                host_toks[host_emit[:, lane], lane].tolist())
        for lane in np.flatnonzero(was_active & ~self.active & ~poison):
            self._finish_lane(int(lane), now)
        for lane in np.flatnonzero(poison):
            self._quarantine_lane(int(lane))

    def _quarantine_lane(self, lane: int) -> None:
        """A lane tripped the non-finite sentinel: free it (its state rows
        are overwritten by the next admission's splice) and retry the
        request from its prompt — requeued at its arrival rank, prefilled
        again, its seed memoized (`_seed_keys`), so greedy and seeded
        sampled streams come back token-identical. The poisoned
        incarnation's tokens are dropped (the retry emits them again).
        After `max_retries` quarantines the request resolves "failed" and
        keeps its clean partial stream."""
        rid = self._lane_rid[lane]
        self.counters["quarantined_lanes"] += 1
        partial = list(self.outputs[lane])
        self.active[lane] = False
        self.remaining[lane] = 0
        self.outputs[lane] = []
        self._lane_rid[lane] = None
        self._reset_lane_knobs(lane)
        req = self._req_by_rid[rid]
        st = self.stats[rid]
        req.retries += 1
        st.retries = req.retries
        st.lane = -1
        if req.retries > self.max_retries:
            self.counters["failed_requests"] += 1
            st.tokens = partial                # the clean prefix
            self._finish_queued(req, "failed",
                                "non-finite logits; max_retries="
                                f"{self.max_retries} exhausted")
        else:
            self.counters["retried_requests"] += 1
            self._requeue(req)

    def _finish_lane(self, lane: int, now: float, outcome: str = "done",
                     detail: str = "") -> None:
        rid = self._lane_rid[lane]
        st = self.stats[rid]
        if st.t_first < st.t_admit:     # nothing emitted (first token EOS)
            st.t_first = now
        st.tokens = list(self.outputs[lane])
        st.t_done = now
        st.outcome = outcome
        st.detail = detail
        st.occupancy = self._lane_occupancy(lane)
        self.completed.append(st)
        self._finished.add(rid)
        self._lane_rid[lane] = None
        self._req_by_rid.pop(rid, None)
        self.active[lane] = False
        self._reset_lane_knobs(lane)
        if outcome == "done":
            # drain-prediction statistics, natural completions only (a
            # cancelled or expired lane has budget left and is no EOS
            # sample): a lane that stopped with budget left stopped on its
            # stop token
            if self.remaining[lane] > 0:
                self._eos_lens.append(len(st.tokens))
                self._eos_by_class.setdefault(
                    (st.priority, st.bucket), []).append(len(st.tokens))
            else:
                self._budget_done += 1

    def _lane_occupancy(self, lane: int) -> float:
        """The lane's mean fill over its cache layers, as a share of the
        slots (0.0 for a model with no cache)."""
        sh, row = self._local(lane)
        kv = self._states[sh].kv
        if kv is None:
            return 0.0
        return float(kv.fill[:, row].float().mean()) / kv.slots

    # -- driver ----------------------------------------------------------------

    def run(self) -> List[RequestStats]:
        """Drive until the queue is drained and every lane is idle. Each
        round sweeps cancelled and expired lanes, schedules, ticks the
        degrade ladder, runs at most one prefill slice, then one decode
        block.

        Hang-proof: a round that admits, slices and decodes nothing while
        requests wait, the lanes idle and nothing is due to arrive means
        the scheduler cannot place the waiting work; after three such
        rounds it resolves "rejected" (`_fail_stuck`). A chaos blackout
        is exempt: it sleeps 1 ms a round until the round counter ends
        it."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        idle = 0
        while (self._arrived_count or self._arrivals or self._reserved
               or self.active.any() or self._pending is not None):
            self._rounds += 1
            self._sweep_lanes(self._now())
            admitted = self.schedule()
            self._pressure_tick()
            sliced = self._advance_chunked()
            if self.active.any():
                self._step_block()
            elif not (admitted or sliced):
                # a cancelled future arrival is resolved now, not slept
                # out
                while self._arrivals and self._arrivals[0].cancelled:
                    self._resolve_dead(self._arrivals.popleft())
                if self._arrivals:
                    wait = self._arrivals[0].arrival - self._now()
                    if wait > 0:
                        time.sleep(min(wait, 0.05))
                elif self._blackout_active():
                    time.sleep(0.001)
                elif self._arrived_count or self._reserved:
                    idle += 1
                    if idle >= 3:
                        self._fail_stuck()
                        idle = 0
                continue
            idle = 0
        return self.completed

    def _fail_stuck(self) -> None:
        """Last-resort hang breaker: resolve every waiting request
        "rejected" (the scheduler made no progress with idle lanes and
        nothing pending or arriving)."""
        stuck: List[Request] = list(self._reserved)
        self._reserved.clear()
        for key in list(self._bucket_q):
            dq = self._bucket_q.pop(key)
            self._arrived_count -= len(dq)
            stuck.extend(dq)
        for req in stuck:
            self.counters["rejected_requests"] += 1
            self._finish_queued(req, "rejected",
                                "scheduler made no progress — request "
                                "cannot be placed")

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
        if self.shards > 1:
            # per-shard throughput and tokens per decode-block dispatch
            out["shards"] = float(self.shards)
            for i, t in enumerate(self._shard_tokens):
                out[f"shard{i}_tokens"] = float(t)
                out[f"shard{i}_tok_s"] = float(t) / wall
            out["tokens_per_dispatch"] = (
                float(self._shard_tokens.sum())
                / max(self.counters["decode_blocks"], 1))
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    help="a registered config: the dense family, "
                         "grok-1-314b, deepseek-v3-671b, mamba2-1.3b (SSM: "
                         "no cache, so the policy only names the run), "
                         "zamba2-7b (hybrid) or whisper-base (enc-dec: "
                         "not with --serve)")
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
                    help="sampling temperature (0 = greedy; --serve only)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="truncate sampling to the k most likely tokens "
                         "(0 = full distribution; --serve only)")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling: truncate to the smallest token "
                         "set with cumulative probability >= p (0 = "
                         "disabled; --serve only)")
    ap.add_argument("--no-window", action="store_true",
                    help="accepted for the reference's command lines: the "
                         "port always decodes at full slot width, and the "
                         "kernel skips each lane's dead slot blocks")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                         "card — pass cpu to run the plain PyTorch path)")
    args = ap.parse_args(argv)

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
                         temperature=args.temperature, top_k=args.top_k,
                         top_p=args.top_p,
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
    if cfg.frontend != "none":     # the stub's embeddings, from the seed
        key = ("enc_embed" if cfg.family == "encdec"
               else f"{cfg.frontend}_embed")
        batch[key] = torch.as_tensor(
            rng.standard_normal((args.batch, cfg.frontend_len,
                                 cfg.d_model)).astype(np.float32),
            device=model.device)
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
