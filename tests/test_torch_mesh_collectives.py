"""The port's collective paths in one 4-rank gloo world on the CPU, held to
the reference.

The reference's own multi-device tests run shard_map under forced host
devices; here the reference runs single-device in this process and the
port runs as four processes (`tests/torch_mesh_worker.py`) joined by a
file store, once for the whole file. Checks, each a test:
- the slot-sharded blocked decode (`core.attention`), 24 steps at
  `tests/test_shardmap_decode.py`'s shapes (B 4, Hq 8, Hk 4, d 32, S 64,
  select_k 16) on (1 x 4) with 4 blocks, on (2 x 2) with 2 (the batch on
  `data`) and with 4 (the slots over model and data), f32 and int8 KV,
  and 48 steps of a 32-slot cache that evicts: every step's output
  within 2e-4 of the reference's single-device blocked decode (the `ref`
  that test compares with), the final cache block's valid, pos, fill and
  step equal, and the output and acc within 1e-5 of the port's own
  unsharded decode;
- MLA's latent race (`_mla_blocked_shardmap`) against that file's dense
  latent attention at full budget, 2e-4, on (1 x 4) and (2 x 2);
- MoE expert parallelism (`apply_moe_ep_shardmap`, reduced grok-1, 8
  experts, top-2, capacity factor 8, f32) against the reference's
  `apply_moe`, 2e-4 (and the aux loss where every rank routes every
  token);
- the global race (select_blocks 1) on a cache slot-sharded over 4
  ranks, composed and fused (the sharded route's plain stages), 48 steps
  into 32 slots at the same shapes (8 slots a rank, fewer than select_k),
  f32 and int8 KV: each step's output within 2e-4 of
  the reference's single-device global race, winner sets equal to the
  port's unsharded race's at every step, the final block's fields equal;
- `Model.decode_step` on a state laid out by `decode_state_pspecs`
  (reduced granite-3-2b with 4 kv-heads on (1 x 4), (2 x 2) at batch 1
  and 2; reduced longchat-7b with 2 on (1 x 4) and (2 x 2) at batch 1;
  2 layers, f32, S 64, select_k 16, bf16 and int8 KV, 24 greedy steps
  past the point where the cache evicts, composed and fused): logits
  within 1e-4 of the reference's unsharded decode, greedy tokens equal,
  winner sets equal to the port's unsharded run's, each rank's final
  block equal to the unsharded cache's (acc within 1e-5); reduced
  grok-1-314b (MoE, expert parallelism) on (2 x 2) and (1 x 4) at batch
  2, int8 KV: logits within 1e-5 of the port's unsharded decode, greedy
  tokens equal; the families the layout does not take yet refused;
- a whole (unsharded) state of reduced granite-3-2b and of reduced
  deepseek-v3-671b decoded by `Model.decode_step` under a (1 x 4) mesh
  that could slot-shard it: logits and cache bit-equal to the same steps
  with no mesh, through eviction; and a slot-sharded cache refuses a step
  of a race the slot ranks cannot share before it writes anything;
- `compressed_psum` on four per-rank inputs: the all-gathered int8 codes
  and f32 scales equal the reference's `quantize_grad` of each input, and
  the mean is within 1e-6 relative of the reference's body (the
  dequantized pieces summed over the rank axis, / n);
- `elastic_restore` of reduced granite-3-2b's params saved from (2 x 2)
  onto (4 x 1): every leaf bit-equal, each rank holding the shard its new
  placement names;
- `DataPipeline` under a (2 x 2) mesh: each rank's rows of the batch.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import PruneConfig as JaxPrune  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import quant, scoring, topk  # noqa: E402
from repro.core.attention import decode_attention  # noqa: E402
from repro.core.cache import (init_cache, protected_mask,  # noqa: E402
                              write_token)
from repro.core.topk import NEG_INF  # noqa: E402
from repro.models.moe import apply_moe, init_moe  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.launch.serve import (_decode_step_fn, _model_key,  # noqa: E402
                                _prefill_fn)
from repro.optim.compression import quantize_grad  # noqa: E402
from torch_parity import model_pair  # noqa: E402

import torch_mesh_worker as W  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

WORLD = 4
HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_prune(p) -> JaxPrune:
    return JaxPrune(**{f.name: getattr(p, f.name)
                       for f in dataclasses.fields(p)})


def _decode_ref(out, name, nb, kv, steps, heavy):
    """The reference's single-device blocked decode over seeded inputs."""
    prune = _jax_prune(W.decode_prune(nb, kv, heavy))
    cache = init_cache(W.B, W.HK, W.D, prune.slots, prune, jnp.float32)
    step = jax.jit(lambda c, q, k, v: decode_attention(c, q, k, v, prune))
    rng = np.random.default_rng(len(name))
    qs, ks, vs, outs = [], [], [], []
    for _ in range(steps):
        q = rng.standard_normal((W.B, W.HQ, W.D)).astype(np.float32)
        k = rng.standard_normal((W.B, W.HK, W.D)).astype(np.float32)
        v = rng.standard_normal((W.B, W.HK, W.D)).astype(np.float32)
        cache, o = step(cache, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
        qs.append(q), ks.append(k), vs.append(v), outs.append(np.asarray(o))
    for x, arr in (("q", qs), ("k", ks), ("v", vs), ("out", outs)):
        out[f"{name}/{x}"] = np.stack(arr)
    for f, a in cache._asdict().items():
        if a is not None:
            out[f"{name}/cache/{f}"] = np.asarray(a)


def _model_ref(out, m, arch, kw):
    """The reference's unsharded greedy decode of reduced `arch` (f32,
    `model_pair`'s weights) over two seeded prompts: its weights, the
    prompts, and for each KV dtype every step's logits and tokens."""
    from repro_torch.tree import flatten_with_paths
    rng = np.random.default_rng(0)
    for kv in W.MODEL_KV:
        jm, jp, tm, _ = model_pair(arch, cfg_kw=dict(kw), kv_dtype=kv,
                                   fused=False, **W.MODEL_PRUNE)
        if f"model_{m}/tokens" not in out:
            out[f"model_{m}/tokens"] = rng.integers(
                0, tm.cfg.vocab_size, (2, W.MODEL_PROMPT)).astype(np.int32)
            for path, a in flatten_with_paths(jax.tree.map(np.asarray, jp)):
                out[f"model_{m}/p/{path}"] = a
        logits, st = _prefill_fn(_model_key(jm))(
            jp, {"tokens": jnp.asarray(out[f"model_{m}/tokens"])})
        step = _decode_step_fn(_model_key(jm))
        outs, toks = [np.asarray(logits)], []
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for _ in range(W.MODEL_STEPS):
            toks.append(np.asarray(tok))
            logits, st = step(jp, st, tok)
            outs.append(np.asarray(logits))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out[f"model_{m}_{kv}/logits"] = np.stack(outs)
        out[f"model_{m}_{kv}/toks"] = np.stack(toks, 1)


def _mla_ref(out, name, nb):
    """test_shardmap_decode.py's MLA_SCRIPT inputs and its dense `ref`."""
    b, h, s, lat, kvr = W.B, 8, 64, 40, 32
    prune = _jax_prune(W.mla_prune(s, nb))
    cache = init_cache(b, 1, lat, s, prune, jnp.float32, latent=True)
    for i in range(50):
        u = jax.random.normal(jax.random.PRNGKey(i), (b, 1, lat))
        cache = write_token(cache, u, None, prune)
    q_full = jax.random.normal(jax.random.PRNGKey(99), (b, h, lat))
    qq, qs = quant.quantize_query(q_full, prune.query_bits)
    s_apx = scoring.approx_scores(qq, qs, cache.kq, cache.kscale,
                                  cache.valid)
    grouped = topk.gqa_group_scores(s_apx, 1)
    biased = topk.apply_selection_bias(
        grouped, protected_mask(cache, prune), ~cache.valid)
    scale_dim = 48
    u_all = cache.k[:, 0].astype(jnp.float32)
    logits = jnp.einsum("bhk,bsk->bhs", q_full, u_all) / jnp.sqrt(
        float(scale_dim))
    logits = jnp.where(cache.valid[:, 0][:, None, :], logits, NEG_INF)
    pr = jax.nn.softmax(logits, axis=-1)
    out[f"{name}/ref"] = np.asarray(jnp.einsum("bhs,bsk->bhk", pr,
                                               u_all[:, :, :kvr]))
    out[f"{name}/q"] = np.asarray(q_full)
    out[f"{name}/biased"] = np.asarray(biased)
    out[f"{name}/kv_lora"] = np.asarray(kvr)
    out[f"{name}/scale_dim"] = np.asarray(scale_dim)
    for f, a in cache._asdict().items():
        if a is not None:
            out[f"{name}/cache/{f}"] = np.asarray(a)


def _moe_ref(out):
    cfg = jax_reduced(jax_get_config("grok-1-314b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=8.0))
    params = init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model))
    y, aux = apply_moe(params, x, cfg)
    for k in ("router", "wi", "wg", "wo"):
        out[f"moe/p/{k}"] = np.asarray(params[k])
    out["moe/x"], out["moe/y"] = np.asarray(x), np.asarray(y)
    out["moe/aux"] = np.asarray(aux)


def _psum_ref(out):
    xs = np.random.default_rng(5).standard_normal((WORLD, 6, 24)).astype(
        np.float32) * np.float32(3.0)
    q, s = zip(*(quantize_grad(jnp.asarray(x)) for x in xs))
    qg, sg = jnp.stack(q), jnp.stack(s)
    out["psum/x"] = xs
    out["psum/codes"], out["psum/scales"] = np.asarray(qg), np.asarray(sg)
    out["psum/mean"] = np.asarray(
        jnp.sum(qg.astype(jnp.float32) * sg, axis=0) / WORLD)


def _elastic_ref(out):
    from repro_torch.tree import flatten_with_paths
    cfg = jax_reduced(jax_get_config("granite-3-2b"), n_heads=4,
                      n_kv_heads=2)
    model = JaxModel(cfg, jax_baselines.unicaim(48, 16, 16))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    for path, a in flatten_with_paths(params):
        out[f"elastic/p/{path}"] = a


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the reference, then the four ranks once → {check: [per rank]}."""
    tmp = tmp_path_factory.mktemp("mesh")
    ref = {}
    for name, _, nb, kv, steps, heavy in W.DECODE:
        _decode_ref(ref, name, nb, kv, steps, heavy)
    for name, _, kv, _ in W.GLOBAL:
        _decode_ref(ref, name, 1, kv, W.GLOBAL_STEPS, W.GLOBAL_HEAVY)
    for m, arch, kw, _ in W.MODELS:
        _model_ref(ref, m, arch, kw)
    for name, _, nb in W.MLA:
        _mla_ref(ref, name, nb)
    _moe_ref(ref)
    _psum_ref(ref)
    _elastic_ref(ref)
    np.savez(tmp / "ref.npz", **ref)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
         str(r), str(WORLD), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=240)
            logs.append((p.returncode, o[-2000:], e[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(rc == 0 for rc, _, _ in logs), logs
    ranks = [json.load(open(tmp / f"rank{r}.json")) for r in range(WORLD)]
    return {name: [r[name] for r in ranks] for name in ranks[0]}


def _held(world, name):
    for r, res in enumerate(world[name]):
        assert res["ok"], (name, r, res["err"], res["detail"])


@pytest.mark.parametrize("name", [d[0] for d in W.DECODE])
def test_slot_sharded_decode_matches_single_device_blocked(world, name):
    _held(world, name)


@pytest.mark.parametrize("name", [g[0] for g in W.GLOBAL])
def test_slot_sharded_global_race_matches_single_device(world, name):
    _held(world, name)


@pytest.mark.parametrize("name", [c[0] for c in W.model_cases()])
def test_laid_out_state_decodes_as_the_unsharded_model(world, name):
    _held(world, name)


def test_laid_out_moe_state_decodes_as_the_unsharded_model(world):
    _held(world, "model_moe")


def test_laid_out_state_refuses_the_other_families(world):
    _held(world, "model_refusal")


@pytest.mark.parametrize("name", [m[0] for m in W.MLA])
def test_mla_latent_race_matches_dense_latent_attention(world, name):
    _held(world, name)


@pytest.mark.parametrize("name", [m[0] for m in W.MOE])
def test_moe_expert_parallel_matches_sort_dispatch(world, name):
    _held(world, name)


@pytest.mark.parametrize("name", [w[0] for w in W.WHOLE])
def test_whole_state_decodes_unsharded_under_a_mesh(world, name):
    _held(world, name)


def test_slot_sharded_cache_refuses_another_race(world):
    _held(world, "shard_refusal")


def test_compressed_psum_codes_scales_and_mean(world):
    _held(world, "compressed_psum")


def test_elastic_restore_onto_another_mesh(world):
    _held(world, "elastic_restore")


def test_pipeline_lays_the_batch_out_on_the_batch_rule(world):
    _held(world, "pipeline_batch")
