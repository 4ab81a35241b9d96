"""Shared helpers for the port's parity tests: build the reference model
and the port's model from one config and one seed, with the same weights,
and move arrays between the two (numpy in between)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import baselines as jax_baselines
from repro.launch.serve import _decode_step_fn, _model_key, _prefill_fn
from repro.launch.serve import greedy_generate as jax_greedy
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.base import get_config, reduced
from repro_torch.configs import base as tbase
from repro_torch.core import baselines
from repro_torch.launch.serve import greedy_generate
from repro_torch.models.transformer import Model
from repro_torch.params import from_reference


def prune_pair(policy: str = "unicaim", **kw):
    """The same PruneConfig on both sides, from the baselines of each."""
    return (getattr(jax_baselines, policy)(**kw),
            getattr(baselines, policy)(**kw))


# leaves the reference initialises to constants: zeros (LayerNorm's `b`,
# the qkv bias `bq`/`bk`/`bv`, the SSD block's `A_log`, `dt_bias` and
# `conv_b`) and ones (a norm's weight `w`, MLA's `q_norm`/`kv_norm`, the SSD
# block's `D` and its gate-norm weight `norm_w`). A port that never added a
# bias, dropped the `D` skip, skipped a norm's weight or swapped two norms
# would match on those weights, so `model_pair` replaces them with seeded
# noise of this scale around their constant. `norm_w=False` leaves the
# norms' `w` at one: the MLA tests' one-ulp sensitivity claims were made on
# those weights
ZERO_INIT_LEAVES = ("b", "bq", "bk", "bv", "A_log", "dt_bias", "conv_b")
ONE_INIT_LEAVES = ("q_norm", "kv_norm", "D", "norm_w")
BIAS_NOISE = 0.1


def noisy_const_leaves(tree, seed: int, norm_w: bool = True):
    """The numpy tree with every zero-initialised leaf replaced by seeded
    N(0, BIAS_NOISE²) noise of its shape and dtype, and every
    one-initialised leaf (the norms' `w` too unless `norm_w` is False) by
    1 + that noise (in tree order)."""
    rng = np.random.default_rng(seed)
    ones = ONE_INIT_LEAVES + (("w",) if norm_w else ())

    def walk(t, key=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, key) for v in t]
        if key not in ZERO_INIT_LEAVES + ones:
            return t
        noise = rng.standard_normal(np.shape(t)) * BIAS_NOISE
        if key in ones:
            noise = noise + 1.0
        return noise.astype(np.asarray(t).dtype)

    return walk(tree)


def model_pair(arch: str, policy: str = "unicaim", seed: int = 0,
               cfg_kw=None, moe_kw=None, **kw):
    """(jax model, jax params, port model, port params) for the reduced
    `arch` (f32; `cfg_kw` overrides config fields on both sides, `moe_kw`
    fields of their MoEConfig): the reference's weights with
    `noisy_const_leaves` on both sides, the port's converted from them."""
    jprune, tprune = prune_pair(policy, **kw)
    cfg_kw = cfg_kw or {}

    def cfg(c):
        if moe_kw:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                               **moe_kw))
        return c

    jm = JaxModel(cfg(jax_reduced(jax_get_config(arch), **cfg_kw)), jprune)
    tree = noisy_const_leaves(
        jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed))), seed)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = Model(cfg(reduced(get_config(arch), **cfg_kw)), tprune,
               device="cpu")
    tp = from_reference(tree, "float32", "cpu")
    return jm, jp, tm, tp


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_cfg(jcfg):
    """The reference's ModelConfig as the port's (nested configs too)."""
    fields = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tbase, type(v).__name__)(**dataclasses.asdict(v))
        fields[f.name] = v
    return tbase.ModelConfig(**fields)


def decode_runs(jm, jp, tm, tp, batch, teacher, greedy_steps):
    """Both sides on one batch (a dict of numpy arrays): prefill logits
    stacked with the logits of the teacher-forced decode steps (`teacher`
    [steps, B] tokens) → (jax [1 + steps, B, V], port's), and
    `greedy_generate` over `greedy_steps` → (jax tokens, port's)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jlog, jst = _prefill_fn(_model_key(jm))(jp, jbatch)
    tlog, tst = tm.prefill(tp, tbatch)
    step = _decode_step_fn(_model_key(jm))
    jl, tl = [to_np(jlog)], [to_np(tlog)]
    for tok in teacher:
        lj, jst = step(jp, jst, jnp.asarray(tok))
        lt, tst = tm.decode_step(tp, tst, torch.as_tensor(tok))
        jl.append(to_np(lj))
        tl.append(to_np(lt))
    jtoks, _ = jax_greedy(jm, jp, jbatch, greedy_steps)
    ttoks, _ = greedy_generate(tm, tp, tbatch, greedy_steps, device="cpu")
    return (np.stack(jl), np.stack(tl)), (to_np(jtoks), to_np(ttoks))


# A ServeLoop trace for the recurrent families (exact-length prefills): on
# 2 lanes, block 4, a prefix cache, three requests (length, prompt seed,
# max_new, priority) fill the lanes in one schedule(); then a priority-5
# arrival preempts the lowest-priority lane, and a repeat of the 9-token
# prompt is admitted later from the trie (an exact hit).
TRACE_FIRST = ((16, 1, 10, 0), (12, 2, 8, 0), (9, 3, 6, 0))
TRACE_LATER = ((16, 4, 4, 5), (9, 3, 5, 0))


def trace_prompt(vocab: int, t: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, t)


def drive_trace(model, params, request_cls, loop_cls, vocab, later=True,
                **kw):
    """Drive the trace through `loop_cls` (the reference's ServeLoop or the
    port's, `kw` its own arguments) → (handles, loop); `later=False` leaves
    out the later arrivals (no preemption, no hit)."""
    loop = loop_cls(model, params, lanes=2, eos=-1, block=4,
                    prefix_cache_bytes=64 << 20, **kw)

    def submit(spec):
        return [loop.submit(request_cls(prompt=trace_prompt(vocab, n, s),
                                        max_new=m, priority=q))
                for n, s, m, q in spec]

    hs = submit(TRACE_FIRST)
    loop.schedule()
    if later:
        hs += submit(TRACE_LATER)
        loop.schedule()
    loop._step_block()
    loop.run()
    return hs, loop
