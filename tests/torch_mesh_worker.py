"""One rank of the 4-rank gloo world of `test_torch_mesh_collectives.py`.

    python tests/torch_mesh_worker.py RANK WORLD DIR

Joins the world through the file store `DIR/store`, reads the reference's
inputs and outputs from `DIR/ref.npz` (written by the test, which runs the
reference), runs every check of the port's collective paths on the CPU
and writes `DIR/rank{RANK}.json`: {check: {"ok": bool, "err": float,
"detail": str}}. Imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: E402
                                            spec_like)
from repro_torch.configs.base import (PruneConfig, get_config,  # noqa
                                      reduced)
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import attention  # noqa: E402
from repro_torch.core.attention import (cut_cache,  # noqa: E402
                                        decode_attention, shard_cache,
                                        shard_decode_state, shard_rows,
                                        slot_layout)
from repro_torch.core.cache import FIELDS, KVCache, init_cache  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from repro_torch.data.pipeline import DataPipeline, SyntheticSource  # noqa
from repro_torch.models.mla import _mla_blocked_shardmap  # noqa: E402
from repro_torch.models.moe import apply_moe_ep_shardmap  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim.compression import (compressed_psum,  # noqa: E402
                                           gather_quantized)
from repro_torch.runtime.fault import elastic_restore  # noqa: E402
from repro_torch.runtime.sharding import (ProcessMesh,  # noqa: E402
                                          params_pspecs, params_shardings,
                                          use_mesh)
from repro_torch.tree import flatten_with_paths, leaves, unflatten  # noqa

# the decode checks: (name, mesh shape, select_blocks, kv dtype, steps,
# heavy budget); the test computes the reference's outputs for each
DECODE = (("decode_1x4_nb4_f32", (1, 4), 4, "bf16", 24, 56),
          ("decode_1x4_nb4_int8", (1, 4), 4, "int8", 24, 56),
          ("decode_2x2_nb2_f32", (2, 2), 2, "bf16", 24, 56),
          ("decode_2x2_nb2_int8", (2, 2), 2, "int8", 24, 56),
          ("decode_2x2_nb4_f32", (2, 2), 4, "bf16", 24, 56),
          ("decode_evict_1x4_nb4", (1, 4), 4, "bf16", 48, 24))
B, HQ, HK, D = 4, 8, 4, 32
MLA = (("mla_1x4_nb4", (1, 4), 4), ("mla_2x2_nb2", (2, 2), 2))
MOE = (("moe_ep_1x4", (1, 4)), ("moe_ep_2x2", (2, 2)))
# a whole state decoded by the model under a mesh that could slot-shard it
WHOLE = (("whole_state_granite", "granite-3-2b"),
         ("whole_state_deepseek", "deepseek-v3-671b"))
# the global race (select_blocks 1) on a cache slot-sharded over 4 ranks:
# (name, mesh shape, kv dtype, fused engine), GLOBAL_STEPS steps into
# GLOBAL_HEAVY + 8 = 32 slots (8 a rank, fewer than select_k = 16), so the
# last 16 evict; the reference's decode is the single-device global race
# of `_decode_ref` at select_blocks 1
GLOBAL = (("global_1x4_f32", (1, 4), "bf16", False),
          ("global_1x4_int8", (1, 4), "int8", False),
          ("global_1x4_f32_fused", (1, 4), "bf16", True),
          ("global_2x2_int8_fused", (2, 2), "int8", True))
GLOBAL_STEPS, GLOBAL_HEAVY = 48, 24
# `Model.decode_step` on a state laid out by `decode_state_pspecs`: the
# reduced models (name, arch, config overrides) and the layouts each runs
# on, (mesh shape, batch): granite with Hk = 4 on (1 x 4) (heads over
# model), (2 x 2) at batch 1 (heads over model, slots over data) and at
# batch 2 (batch over data, heads over model); longchat with Hk = 2 on
# (1 x 4) (slots over model) and (2 x 2) at batch 1 (heads over model,
# slots over data)
MODELS = (("granite_hk4", "granite-3-2b", (("n_heads", 8),
                                           ("n_kv_heads", 4)),
           (((1, 4), 2), ((2, 2), 1), ((2, 2), 2))),
          ("longchat_hk2", "longchat-7b", (), (((1, 4), 2), ((2, 2), 1))))
MODEL_KV = ("bf16", "int8")
# the MoE family on a laid-out state: reduced grok-1-314b (Hk = 2) on
# (2 x 2) (batch over data, heads over model) and (1 x 4) (slots over
# model) at batch 2
MOE_LAYOUTS = ((2, 2), (1, 4))
MODEL_PROMPT, MODEL_STEPS = 60, 24      # 56 kept + 8 appends, then evicts
REF_ATOL = 1e-4                         # tests/test_torch_model.py's
MODEL_PRUNE = dict(heavy=56, reserve=8, select_k=16, sink_tokens=2,
                   recent_window=4)


def model_cases():
    """[(check name, model name, arch, overrides, kv, mesh shape, batch)]."""
    return [(f"model_{m}_{kv}_{a}x{b}_b{batch}", m, arch, dict(kw), kv,
             (a, b), batch)
            for m, arch, kw, layouts in MODELS for kv in MODEL_KV
            for (a, b), batch in layouts]


def decode_prune(nb: int, kv: str, heavy: int) -> PruneConfig:
    """test_shardmap_decode.py's pruning (heavy 56 + reserve 8 = 64 slots),
    at `nb` blocks and KV dtype `kv` (bf16 names the f32 cache there: the
    reference's test stores f32)."""
    return PruneConfig(policy="unicaim", heavy_budget=heavy, reserve=8,
                       sink_tokens=2, recent_window=4, select_k=16,
                       select_blocks=nb, score_bits=8, query_bits=8,
                       kv_dtype=kv)


def mla_prune(s: int, nb: int) -> PruneConfig:
    return PruneConfig(policy="unicaim", heavy_budget=s - 8, reserve=8,
                       sink_tokens=2, recent_window=4, select_k=s,
                       select_blocks=nb, score_bits=8, query_bits=8)


def moe_cfg():
    cfg = reduced(get_config("grok-1-314b"))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=8.0))


def mesh_of(shape) -> ProcessMesh:
    from torch.distributed.device_mesh import init_device_mesh
    return ProcessMesh(init_device_mesh("cpu", shape,
                                        mesh_dim_names=("data", "model")))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def check_decode(ref, name, shape, nb, kv, steps, heavy):
    """Each step's output against the reference's (2e-4); the final cache
    block's valid, pos, fill and step equal to the reference's; and the
    output and acc against the port's own unsharded decode of the whole
    cache on this rank (1e-5: only the order of the cross-rank sums
    differs). The acc's distance from the reference's is printed: an int8
    code that rounds the other way moves a probability by ~1e-4 there,
    on either package's unsharded decode."""
    mesh = mesh_of(shape)
    prune = decode_prune(nb, kv, heavy)
    whole = init_cache(B, HK, D, prune.slots, prune, torch.float32)
    cache = shard_cache(whole, mesh, nb)
    worst = own = 0.0
    for i in range(steps):
        q, kn, vn = (t(ref[f"{name}/{x}"][i]) for x in ("q", "k", "v"))
        plain = decode_attention(whole, q, kn, vn, prune)
        with use_mesh(mesh):
            out = decode_attention(cache, *(shard_rows(x, mesh, nb, B)
                                            for x in (q, kn, vn)), prune)
        want = shard_rows(t(ref[f"{name}/out"][i]), mesh, nb, B)
        worst = max(worst, float((out - want).abs().max()))
        own = max(own, float((out - shard_rows(plain, mesh, nb, B)
                              ).abs().max()))
    # the final cache: this rank's block of the reference's
    fin = KVCache(**{f: (t(ref[f"{name}/cache/{f}"])
                         if f"{name}/cache/{f}" in ref else None)
                     for f in FIELDS})
    want = shard_cache(fin, mesh, nb)
    exact = all(torch.equal(getattr(cache, f), getattr(want, f))
                for f in ("valid", "pos", "fill", "step"))
    acc_own = float((cache.acc - shard_cache(whole, mesh, nb).acc
                     ).abs().max())
    acc_ref = float((cache.acc - want.acc).abs().max())
    batch_axes, slot_axes = slot_layout(mesh, nb, B)
    return {"ok": worst <= 2e-4 and exact and own <= 1e-5
            and acc_own <= 1e-5,
            "err": worst,
            "detail": f"batch axes {batch_axes} slot axes {slot_axes}; "
                      f"valid/pos/fill/step equal {exact}; unsharded port: "
                      f"out {own:.3g}, acc {acc_own:.3g}; acc vs the "
                      f"reference {acc_ref:.3g}"}


def check_mla(ref, name, shape, nb):
    mesh = mesh_of(shape)
    s = ref[f"{name}/cache/k"].shape[2]
    prune = mla_prune(s, nb)
    whole = KVCache(**{f: (t(ref[f"{name}/cache/{f}"])
                           if f"{name}/cache/{f}" in ref else None)
                       for f in FIELDS})
    cache = shard_cache(whole, mesh, nb)
    batch_axes, slot_axes = slot_layout(mesh, nb, B)
    biased = t(ref[f"{name}/biased"])
    bi = (mesh.coord(batch_axes), mesh.size(batch_axes)) if batch_axes \
        else (0, 1)
    si, sn = mesh.coord(slot_axes), mesh.size(slot_axes)
    step_b, step_s = biased.shape[0] // bi[1], biased.shape[2] // sn
    biased = biased[bi[0] * step_b:(bi[0] + 1) * step_b, :,
                    si * step_s:(si + 1) * step_s]
    q = shard_rows(t(ref[f"{name}/q"]), mesh, nb, B)
    with use_mesh(mesh):
        ctx = _mla_blocked_shardmap(cache, q, biased, prune,
                                    int(ref[f"{name}/kv_lora"]),
                                    int(ref[f"{name}/scale_dim"]))
    want = shard_rows(t(ref[f"{name}/ref"]), mesh, nb, B)
    err = float((ctx - want).abs().max())
    return {"ok": err <= 2e-4, "err": err,
            "detail": f"batch axes {batch_axes} slot axes {slot_axes}"}


def check_whole_state(arch):
    """`Model.decode_step` on a whole (unsharded) state, made by a prompt
    pass with no mesh, under an active (1 x 4) mesh whose slot axes would
    split the blocked race of 4 blocks: the logits and every cache field
    equal those of the same steps with no mesh, bit for bit, through
    static pruning's keep, 8 appends and 4 evictions. The layout is the
    cache's own (`shard_cache`, `shard_decode_state`, a prompt pass under
    a mesh), never the active mesh's at a decode step."""
    mesh = mesh_of((1, 4))
    cfg = reduced(get_config(arch))
    prune = baselines.unicaim(heavy=24, reserve=8, select_k=8,
                              select_blocks=4, fused=False)
    model = Model(cfg, prune, device="cpu")
    params = model.init(0)
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 32),
                                     generator=gen)}
    toks = torch.randint(0, cfg.vocab_size, (12, B), generator=gen)
    runs = []
    for meshed in (False, True):
        logits, st = model.prefill(params, batch)
        with use_mesh(mesh if meshed else None):
            out = [logits]
            for tok in toks:
                lt, st = model.decode_step(params, st, tok)
                out.append(lt)
        runs.append((torch.stack(out), st.kv))
    (l0, kv0), (l1, kv1) = runs
    fields = [f for f in FIELDS if getattr(kv0, f) is not None]
    same = torch.equal(l0, l1) and all(
        torch.equal(getattr(kv0, f), getattr(kv1, f)) for f in fields)
    evicted = bool((kv1.fill == prune.slots).all())
    return {"ok": same and evicted and kv1.shard is None,
            "err": float((l0 - l1).abs().max()),
            "detail": f"{arch}: logits and {fields} bit-equal {same}; "
                      f"full cache {evicted}"}


def check_global(ref, name, shape, kv, fused):
    """The global race (select_blocks 1) on a cache slot-sharded over the 4
    ranks (`shard_cache` with 4 blocks), composed or fused (on the CPU the
    sharded route's plain stages), GLOBAL_STEPS steps: each step's output
    against the reference's single-device global race (2e-4), the final
    block's valid, pos, fill and step equal to the reference's, and the
    output and acc within 1e-5 of the port's own unsharded decode of the whole
    cache, whose winner sets equal the sharded race's at every step."""
    mesh = mesh_of(shape)
    prune = dataclasses.replace(decode_prune(1, kv, GLOBAL_HEAVY),
                                fused=fused)
    whole = init_cache(B, HK, D, prune.slots, prune, torch.float32)
    cache = shard_cache(whole, mesh, 4)
    worst = own = 0.0
    for i in range(GLOBAL_STEPS):
        q, kn, vn = (t(ref[f"{name}/{x}"][i]) for x in ("q", "k", "v"))
        with Winners(HK) as w_plain:
            plain = decode_attention(whole, q, kn, vn, prune)
        with use_mesh(mesh), Winners(HK) as w_shard:
            out = decode_attention(cache, *(shard_rows(x, mesh, 4, B)
                                            for x in (q, kn, vn)), prune)
        rows = shard_rows(torch.arange(B), mesh, 4, B)
        same = w_plain.equal_on(w_shard, rows, slice(None))
        if not same:
            return {"ok": False, "err": float("nan"),
                    "detail": f"step {i}: winner sets differ"}
        want = shard_rows(t(ref[f"{name}/out"][i]), mesh, 4, B)
        worst = max(worst, float((out - want).abs().max()))
        own = max(own, float((out - shard_rows(plain, mesh, 4, B)
                              ).abs().max()))
    fin = KVCache(**{f: (t(ref[f"{name}/cache/{f}"])
                         if f"{name}/cache/{f}" in ref else None)
                     for f in FIELDS})
    want = shard_cache(fin, mesh, 4)
    exact = all(torch.equal(getattr(cache, f), getattr(want, f))
                for f in ("valid", "pos", "fill", "step"))
    acc_own = float((cache.acc - shard_cache(whole, mesh, 4).acc
                     ).abs().max())
    evicted = bool((whole.fill == prune.slots).all())
    return {"ok": worst <= 2e-4 and exact and own <= 1e-5
            and acc_own <= 1e-5 and evicted,
            "err": worst,
            "detail": f"fused {fused}; winner sets equal; valid/pos/fill/"
                      f"step equal {exact}; unsharded port: out {own:.3g}, "
                      f"acc {acc_own:.3g}; full cache {evicted}"}


class Winners:
    """Records every decode step's winner sets, as global slots [B, Hk, k]
    of a cache of `hk` kv-heads, whichever race computed them: the
    composed global race (`_gathered_attend`, or on a slot-split cache
    `_global_topk_shardmap`), the fused engine's plain race
    (`ref.decode_race`), or the sharded route's plain global race
    (`ref.merge_candidates`)."""

    def __init__(self, hk: int):
        self.hk = hk

    def __enter__(self):
        self.sets, self._saved = [], []

        def wrap(mod, name, pick):
            orig = getattr(mod, name)

            def fn(*a, **kw):
                r = orig(*a, **kw)
                idx = pick(a, r)
                self.sets.append(idx.reshape(-1, self.hk, idx.shape[-1]))
                return r
            self._saved.append((mod, name, orig))
            setattr(mod, name, fn)
        wrap(attention, "_gathered_attend", lambda a, r: a[2])
        wrap(attention, "_global_topk_shardmap", lambda a, r: r)
        wrap(kref, "decode_race", lambda a, r: r[1])
        wrap(kref, "merge_candidates", lambda a, r: r)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        return False

    def equal_on(self, other, rows, heads) -> bool:
        """`other`'s sets (a rank's batch `rows` and kv-`heads`, index
        tensors or slices) equal these (the whole cache's) cut to them,
        race by race."""
        if len(self.sets) != len(other.sets) or not self.sets:
            return False
        return all(torch.equal(torch.sort(a[rows][:, heads], -1).values,
                               torch.sort(b, -1).values)
                   for a, b in zip(self.sets, other.sets))


def model_params(ref, m):
    """Model `m`'s weights from the reference (as `torch_parity.model_pair`
    made them) as the port's tree."""
    prefix, tree = f"model_{m}/p/", {}
    for key in ref:
        if key.startswith(prefix):
            node = tree
            *parts, last = key[len(prefix):].split("/")
            for part in parts:
                node = node.setdefault(part, {})
            node[last] = ref[key]
    return from_reference(tree, "float32", "cpu")


def greedy(model, params, tokens, steps):
    """`greedy_generate`'s loop, keeping every step's logits → (logits
    [1 + steps, B, V], tokens [B, steps], final state)."""
    logits, st = model.prefill(params, {"tokens": tokens})
    out, toks = [logits], []
    tok = logits.argmax(-1)
    for _ in range(steps):
        toks.append(tok)
        logits, st = model.decode_step(params, st, tok)
        out.append(logits)
        tok = logits.argmax(-1)
    return torch.stack(out), torch.stack(toks, 1), st


def check_model(ref, m, arch, kw, kv, shape, batch):
    """`Model.decode_step` on a state laid out by `decode_state_pspecs`
    (the prompt pass under the mesh keeps each rank's block), greedy for
    MODEL_STEPS steps past the point where the cache evicts, composed and
    fused (on the CPU the sharded route's plain stages). Against the
    reference's unsharded `Model.decode_step`: every step's logits within
    REF_ATOL (plus, at a step where the port's own unsharded decode lies
    farther than REF_ATOL from it, that distance: with int8 K/V a newly
    written K row's code rounds the other way where the two packages' f32
    projections differ in their last bits) and the greedy tokens equal.
    Against the port's unsharded decode of this rank's batch rows (the
    same batch size, so the same products): every race's winner sets
    equal, the logits within 1e-5, the final block's valid, pos, fill and
    step equal to the unsharded cache's matching block and acc within
    1e-5. The prompt pass's block equals `shard_decode_state` of the
    unsharded prompt pass's state."""
    mesh = mesh_of(shape)
    cfg = reduced(get_config(arch), **kw)
    params = model_params(ref, m)
    tokens = t(ref[f"model_{m}/tokens"])[:batch]
    want = t(ref[f"model_{m}_{kv}/logits"])[:, :batch]
    want_toks = t(ref[f"model_{m}_{kv}/toks"])[:batch]
    layout = attention.state_layout(mesh, (cfg.num_layers, batch,
                                           cfg.n_kv_heads, 64, cfg.head_dim))
    rows, heads = (slice(None) if blk is None else slice(
        blk.offset, blk.offset + blk.total // dist.get_world_size(blk.group))
        for blk in layout[:2])
    hk = len(range(cfg.n_kv_heads)[heads])
    err = own = acc = 0.0
    ok, notes = True, []
    for fused in (False, True):
        model = Model(cfg, baselines.unicaim(**MODEL_PRUNE, kv_dtype=kv,
                                             fused=fused), device="cpu")
        with Winners(cfg.n_kv_heads) as w0:
            l0, _, st0 = greedy(model, params, tokens[rows], MODEL_STEPS)
        with use_mesh(mesh), Winners(hk) as w1:
            l1, k1, st1 = greedy(model, params, tokens, MODEL_STEPS)
        _, whole = model.prefill(params, {"tokens": tokens})
        with use_mesh(mesh):
            _, laid = model.prefill(params, {"tokens": tokens})
        cut = shard_decode_state(whole, mesh).kv
        prompt_same = all(torch.equal(getattr(cut, f), getattr(laid.kv, f))
                          for f in FIELDS if getattr(cut, f) is not None)
        blk = cut_cache(st0.kv, attention.Layout(None, *layout[1:]),
                        batch_dim=1)
        exact = all(torch.equal(getattr(st1.kv, f), getattr(blk, f))
                    for f in ("valid", "pos", "fill", "step"))
        d1, d0 = ((x - want[:, rows]).abs().amax(dim=(1, 2))
                  for x in (l1[:, rows], l0))
        wide = d0 > REF_ATOL
        limit = REF_ATOL + torch.where(wide, d0, torch.zeros_like(d0))
        e = float((d1 - limit).max()) + REF_ATOL
        err = max(err, e)
        own = max(own, float((l1[:, rows] - l0).abs().max()))
        acc = max(acc, float((st1.kv.acc - blk.acc).abs().max()))
        same = w0.equal_on(w1, slice(None), heads)
        evicted = bool((st0.kv.fill == 64).all())
        toks = torch.equal(k1, want_toks)
        ok &= (e <= REF_ATOL and toks and same and exact and prompt_same
               and evicted)
        notes.append(f"fused {fused}: logits {float(d1.max()):.3g} "
                     f"({int(wide.sum())} steps where the unsharded port "
                     f"is farther than {REF_ATOL:g}: {float(d0.max()):.3g}), "
                     f"tokens equal {toks}, winners equal {same} "
                     f"({len(w1.sets)} races), valid/pos/fill/step equal "
                     f"{exact}, prompt block equal {prompt_same}, evicting "
                     f"{evicted}")
    where = [None if b is None else (b.offset, b.total) for b in layout]
    return {"ok": ok and own <= 1e-5 and acc <= 1e-5, "err": err,
            "detail": f"layout rows/heads/slots {where}; unsharded port "
                      f"logits {own:.3g}, acc {acc:.3g}; " + "; ".join(notes)}


def check_model_moe():
    """`Model.decode_step` of reduced grok-1-314b (MoE with expert
    parallelism over `model`, capacity factor 8, so no token is dropped)
    on a state laid out by `decode_state_pspecs` (MOE_LAYOUTS, batch 2,
    int8 K/V, composed and fused), MODEL_STEPS greedy steps past the point
    where the cache evicts: every step's logits within 1e-5 of the port's
    unsharded decode with no mesh (the sort-based dispatch; the port's MoE
    model is held to the reference's in tests/test_torch_moe.py) and the
    greedy tokens equal."""
    base = reduced(get_config("grok-1-314b"))
    cfg = dataclasses.replace(base, moe_ep=True, moe=dataclasses.replace(
        base.moe, capacity_factor=8.0))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, MODEL_PROMPT),
                           generator=gen)
    err, ok, notes = 0.0, True, []
    for shape in MOE_LAYOUTS:
        mesh = mesh_of(shape)
        for fused in (False, True):
            prune = baselines.unicaim(**MODEL_PRUNE, kv_dtype="int8",
                                      fused=fused)
            model = Model(cfg, prune, device="cpu")
            params = model.init(0)
            l0, k0, st0 = greedy(model, params, tokens, MODEL_STEPS)
            with use_mesh(mesh):
                l1, k1, _ = greedy(model, params, tokens, MODEL_STEPS)
            e = float((l1 - l0).abs().max())
            same = torch.equal(k0, k1)
            evicted = bool((st0.kv.fill == 64).all())
            err = max(err, e)
            ok &= e <= 1e-5 and same and evicted
            notes.append(f"{shape} fused {fused}: logits {e:.3g}, tokens "
                         f"equal {same}, evicting {evicted}")
    return {"ok": ok, "err": err, "detail": "; ".join(notes)}


def check_model_refusal():
    """Under a (1 x 4) mesh that lays the state out, the prompt pass of an
    MLA, SSM, hybrid or enc-dec model raises before it computes anything,
    and `shard_decode_state` refuses their states."""
    mesh = mesh_of((1, 4))
    refused = []
    for arch in ("deepseek-v3-671b", "mamba2-1.3b", "zamba2-7b",
                 "whisper-base"):
        model = Model(reduced(get_config(arch)), baselines.unicaim(
            heavy=56, reserve=8, select_k=16), device="cpu")
        state = model.init_decode_state(2, cross_len=8 if arch ==
                                        "whisper-base" else 0)
        for call in (lambda: model._mesh_layout(2),
                     lambda: shard_decode_state(state, mesh)):
            try:
                with use_mesh(mesh):
                    call()
                refused.append(False)
            except ValueError:
                refused.append(True)
    return {"ok": all(refused), "err": 0.0, "detail": f"refused {refused}"}


def check_shard_refusal():
    """A slot-sharded cache refuses, before it writes anything, a step whose
    race the slot ranks cannot share: 2 blocks on a 4-rank shard, the
    threshold race, the dense and h2o policies."""
    mesh = mesh_of((1, 4))
    prune = decode_prune(4, "bf16", 56)
    whole = init_cache(B, HK, D, prune.slots, prune, torch.float32)
    cache = shard_cache(whole, mesh, 4)
    before = cache.clone()
    x = torch.randn(B, HQ, D)
    refused = []
    for other in (dataclasses.replace(prune, select_blocks=2),
                  dataclasses.replace(prune, select_blocks=1,
                                      select_mode="threshold"),
                  dataclasses.replace(prune, policy="dense"),
                  dataclasses.replace(prune, policy="h2o")):
        try:
            decode_attention(cache, x, x[:, :HK], x[:, :HK], other)
            refused.append(False)
        except ValueError:
            refused.append(True)
    untouched = all(torch.equal(getattr(cache, f), getattr(before, f))
                    for f in FIELDS if getattr(cache, f) is not None)
    return {"ok": all(refused) and untouched, "err": 0.0,
            "detail": f"refused {refused}; cache untouched {untouched}"}


def check_moe(ref, name, shape):
    mesh = mesh_of(shape)
    cfg = moe_cfg()
    p = {k: t(ref[f"moe/p/{k}"]) for k in ("router", "wi", "wg", "wo")}
    x = t(ref["moe/x"])
    dp = mesh.shape["data"]
    rows = x.shape[0] // dp
    lo = mesh.coord("data") * rows
    y, aux = apply_moe_ep_shardmap(p, x[lo:lo + rows], cfg, mesh)
    # the experts as DTensors laid out by the rules (experts on "model")
    sh = params_shardings({"moe": p}, mesh)["moe"]
    dp = {k: (sh[k].apply(v) if k != "router" else v) for k, v in p.items()}
    y_dt, _ = apply_moe_ep_shardmap(dp, x[lo:lo + rows], cfg, mesh)
    err = max(float((y - t(ref["moe/y"])[lo:lo + rows]).abs().max()),
              float((y_dt - y).abs().max()))
    ok = err <= 2e-4
    detail = (f"ep {mesh.shape['model']}, {rows} of {x.shape[0]} rows; "
              f"experts as DTensors {sh['wi'].spec}")
    if dp == 1:     # every rank routes every token: the aux is the whole's
        aux_err = abs(float(aux) - float(ref["moe/aux"]))
        ok = ok and aux_err <= 1e-6
        detail += f"; aux |d| {aux_err:.3g}"
    return {"ok": ok, "err": err, "detail": detail}


def check_psum(ref, rank):
    mesh = mesh_of((4, 1))
    x = t(ref["psum/x"][rank])
    qg, sg = gather_quantized(x, mesh.group("data"))
    codes = (np.array_equal(qg.numpy(), ref["psum/codes"])
             and np.array_equal(sg.numpy(), ref["psum/scales"]))
    mean = compressed_psum(x, mesh, "data")
    want = t(ref["psum/mean"])
    rel = float(((mean - want).abs() / want.abs().clamp(min=1e-30)).max())
    return {"ok": codes and rel <= 1e-6, "err": rel,
            "detail": f"codes and scales equal {codes}"}


def check_elastic(ref, tmp):
    mesh_a, mesh_b = mesh_of((2, 2)), mesh_of((4, 1))
    names = sorted(k[len("elastic/p/"):] for k in ref
                   if k.startswith("elastic/p/"))
    params = {}
    for n in names:                         # "seg0_dense/attn/wq" etc.
        node = params
        *parts, last = n.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = t(ref[f"elastic/p/{n}"])
    sh_a = params_shardings(params, mesh_a)
    flat_p, flat_s = leaves(params), leaves(sh_a)
    placed_leaves = [s.apply(x) for x, s in zip(flat_p, flat_s)]
    placed = unflatten(params, iter(placed_leaves))
    mgr = CheckpointManager(os.path.join(tmp, "elastic_ckpt"), keep=1,
                            async_save=False)
    mgr.save(7, placed, block=True)
    with use_mesh(mesh_b):
        restored = elastic_restore(
            mgr, spec_like(params),
            lambda: params_shardings(params, mesh_b))
    specs = params_pspecs(params, mesh_b)
    equal, owned, on_b = True, True, True
    spec_leaves = leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
    for (path, x), r, spec in zip(flatten_with_paths(params),
                                  leaves(restored), spec_leaves):
        equal &= torch.equal(r.full_tensor(), x)
        on_b &= tuple(r.device_mesh.mesh.shape) == (4, 1)
        want = x
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            n = mesh_b.size(axes)
            want = want.chunk(n, dim)[mesh_b.coord(axes)]
        owned &= torch.equal(r.to_local(), want)
    n_sharded = sum(bool(s) for s in spec_leaves)
    return {"ok": equal and owned and on_b, "err": 0.0,
            "detail": f"{len(names)} leaves ({n_sharded} sharded on "
                      f"(4, 1)): bit-equal {equal}, own shards {owned}, "
                      f"on the new mesh {on_b}"}


def check_pipeline(rank):
    mesh = mesh_of((2, 2))
    src = SyntheticSource(vocab_size=97, seq_len=16, seed=3)
    with use_mesh(mesh):
        pipe = DataPipeline(src, global_batch=8, device="cpu")
        batch = next(pipe)
        pipe.close()
    tok = batch["tokens"]
    rows = 8 // mesh.shape["data"]
    lo = mesh.coord("data") * rows
    want = torch.as_tensor(src.batch(0, 8))
    ok = (torch.equal(tok.to_local(), want[lo:lo + rows])
          and torch.equal(tok.full_tensor(), want))
    return {"ok": ok, "err": 0.0,
            "detail": f"rank {rank}: rows [{lo}, {lo + rows}) of 8"}


def main():
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    ref = dict(np.load(os.path.join(tmp, "ref.npz")))
    checks = {}
    for name, shape, nb, kv, steps, heavy in DECODE:
        checks[name] = lambda a=(name, shape, nb, kv, steps, heavy): \
            check_decode(ref, *a)
    for name, shape, nb in MLA:
        checks[name] = lambda a=(name, shape, nb): check_mla(ref, *a)
    for name, shape in MOE:
        checks[name] = lambda a=(name, shape): check_moe(ref, *a)
    for name, arch in WHOLE:
        checks[name] = lambda a=arch: check_whole_state(a)
    for name, shape, kv, fused in GLOBAL:
        checks[name] = lambda a=(name, shape, kv, fused): check_global(ref,
                                                                       *a)
    for name, *case in model_cases():
        checks[name] = lambda a=case: check_model(ref, *a)
    checks["model_moe"] = check_model_moe
    checks["model_refusal"] = check_model_refusal
    checks["shard_refusal"] = check_shard_refusal
    checks["compressed_psum"] = lambda: check_psum(ref, rank)
    checks["elastic_restore"] = lambda: check_elastic(ref, tmp)
    checks["pipeline_batch"] = lambda: check_pipeline(rank)
    out = {}
    for name, fn in checks.items():
        try:
            out[name] = fn()
        except Exception:                     # reported by the test
            out[name] = {"ok": False, "err": float("nan"),
                         "detail": traceback.format_exc()}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
