"""The rest of the dense family in the port, against the reference.

- LayerNorm, tanh-GELU and relu² (and SwiGLU) against
  `repro.models.layers` on seeded inputs with non-trivial weights and
  biases;
- the port builds every registered config of the reference (deepseek-v3's
  mla_moe, mamba2's SSM, zamba2's hybrid and whisper's enc-dec among
  them), with the reference's parameter tree (key names, shapes, dtypes:
  the MoE router and the SSD blocks' A_log, D and dt_bias in f32 under
  bf16 weights; whisper's encoder and decoder segments, `ln_x`, `xattn`
  and `frontend_adapter`), and `params.from_reference` keeps that tree;
- G = 12 query rows per kv-head (reduced starcoder2-3b with 12 heads over
  one kv-head): teacher-forced decode logits to 1e-4 and greedy tokens
  exactly, fused and composed, bf16 and int8 KV;
- llava-next-mistral-7b: `prefill` with a seeded `vision_embed` and
  bucketed lengths (logits to 1e-4, every lane's `cache.step` = the
  frontend rows + its length), then greedy tokens through
  `greedy_generate`; a frontend model refuses chunked prefill and
  `ServeLoop`.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.launch.serve import _model_key, _prefill_fn  # noqa: E402
from repro.launch.serve import greedy_generate as jax_greedy  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.launch.serve import ServeLoop, greedy_generate  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from torch_parity import (decode_runs, model_pair, port_cfg,  # noqa: E402
                          to_np)

jax.config.update("jax_platform_name", "cpu")

UNICAIM = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2,
               recent_window=8)
# the reference's registered configs the port does not build: none
UNPORTED = set()


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def _cfg_pair(arch, **kw):
    return (jbase.reduced(jbase.get_config(arch), **kw),
            tbase.reduced(tbase.get_config(arch), **kw))


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 7, 64)) * 2 + 0.5).astype(np.float32)
    p = {"w": rng.standard_normal(64).astype(np.float32),
         "b": rng.standard_normal(64).astype(np.float32)}
    if kind == "rms":
        del p["b"]
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind)
    got = L.apply_norm({k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x), kind)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch,act", [("starcoder2-3b", "gelu"),
                                      ("minitron-8b", "relu2"),
                                      ("phi3-medium-14b", "swiglu")])
def test_mlp_activations_match_reference(arch, act):
    """tanh-GELU (jax's default form: the erf form misses by ~1e-3 here),
    relu² and SwiGLU MLPs on the reference's `init_mlp` weights."""
    jcfg, tcfg = _cfg_pair(arch)
    assert jcfg.act == tcfg.act == act
    p = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(1),
                                                  jcfg, 128, jnp.float32))
    assert ("wg" in p) == (act == "swiglu")
    x = np.random.default_rng(4).standard_normal((2, 5, 64)) * 3
    x = x.astype(np.float32)
    want = jlayers.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             act)
    got = L.apply_mlp(from_reference(p), torch.as_tensor(x), act)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5,
                               rtol=0)
    if act == "gelu":         # the erf form would miss: > 1e-4 apart here
        h = torch.as_tensor(x) @ torch.tensor(p["wi"])
        diff = (torch.nn.functional.gelu(h) - L.activate("gelu", h)).abs()
        assert float(diff.max()) > 1e-4


# ---------------------------------------------------------------------------
# which configs the port builds, and their trees
# ---------------------------------------------------------------------------


def test_port_builds_every_config_but_the_unported_families():
    built, refused = set(), set()
    for arch in jbase.list_archs():
        if arch.startswith("__"):
            continue
        cfg = port_cfg(jbase.reduced(jbase.get_config(arch)))
        try:
            Model(cfg, baselines.unicaim(**UNICAIM), device="cpu")
            built.add(arch)
        except NotImplementedError:
            refused.add(arch)
    assert refused == UNPORTED
    assert {"phi3-medium-14b", "starcoder2-3b", "minitron-8b",
            "llava-next-mistral-7b", "grok-1-314b", "longchat-7b",
            "granite-3-2b", "deepseek-v3-671b", "mamba2-1.3b",
            "zamba2-7b", "whisper-base"} <= built
    assert built <= set(a for a in tbase.list_archs() if a[0] != "_")


def _tree_spec(tree):
    if isinstance(tree, dict):
        return {k: _tree_spec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_spec(v) for v in tree]
    dt = str(tree.dtype).replace("torch.", "")
    return (tuple(tree.shape), dt)


PORT_ARCHS = ["longchat-7b", "granite-3-2b", "phi3-medium-14b",
              "starcoder2-3b", "minitron-8b", "llava-next-mistral-7b",
              "grok-1-314b", "mamba2-1.3b", "zamba2-7b", "whisper-base"]


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_init_tree_is_the_reference_tree(arch):
    """bf16 weights: the same keys, shapes and dtypes (the router and the
    SSD blocks' A_log, D and dt_bias in f32), from `Model.init` and through
    `from_reference`."""
    kw = dict(param_dtype="bfloat16")
    if arch == "grok-1-314b":       # shared experts: a list in the tree
        kw["moe"] = dataclasses.replace(
            jbase.reduced(jbase.get_config(arch)).moe, n_shared=1)
    jcfg = jbase.reduced(jbase.get_config(arch), **kw)
    tcfg = port_cfg(jcfg)
    prune = baselines.unicaim(**UNICAIM)
    jm = JaxModel(jcfg, jax_baselines.unicaim(**UNICAIM))
    jtree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    want = _tree_spec(jtree)
    assert _tree_spec(Model(tcfg, prune, device="cpu").init(0)) == want
    assert _tree_spec(from_reference(jtree, "bfloat16")) == want


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_from_reference_keeps_the_ssm_f32_leaves(arch):
    """Under dtype="bfloat16", A_log, D and dt_bias stay f32 with the
    reference's values, every other SSD leaf becomes bf16."""
    jcfg = jbase.reduced(jbase.get_config(arch), param_dtype="bfloat16")
    jm = JaxModel(jcfg, jax_baselines.unicaim(**UNICAIM))
    jtree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tree = from_reference(jtree, "bfloat16")
    seg = "seg0_ssm" if "seg0_ssm" in tree else "ssm_groups"
    for name, want in jtree[seg]["ssm"].items():
        got = tree[seg]["ssm"][name]
        if name in ("A_log", "D", "dt_bias"):
            assert got.dtype == torch.float32, name
            np.testing.assert_array_equal(to_np(got), want)
        else:
            assert got.dtype == torch.bfloat16, name


# ---------------------------------------------------------------------------
# G = 12
# ---------------------------------------------------------------------------

G12 = dict(n_heads=12, n_kv_heads=1)
TEACHER_STEPS, GREEDY_STEPS = 8, 12


def _batch(vocab, n=40, short=29, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (2, n)).astype(np.int32)
    tokens[1, short:] = 0
    return tokens, np.array([n, short], np.int32)


@functools.lru_cache(maxsize=None)
def _g12_runs(kv, fused):
    jm, jp, tm, tp = model_pair("starcoder2-3b", cfg_kw=G12, kv_dtype=kv,
                                fused=fused, **UNICAIM)
    assert tm.cfg.n_heads // tm.cfg.n_kv_heads == 12
    tokens, length = _batch(tm.cfg.vocab_size)
    teacher = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (TEACHER_STEPS, 2)).astype(np.int32)
    return decode_runs(jm, jp, tm, tp, {"tokens": tokens, "length": length},
                       teacher, GREEDY_STEPS)


@pytest.mark.parametrize("kv,fused", [(kv, f) for kv in ("bf16", "int8")
                                      for f in (True, False)])
def test_group_of_twelve_matches_reference(kv, fused):
    (jl, tl), (jt, tt) = _g12_runs(kv, fused)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tt, jt)


# ---------------------------------------------------------------------------
# llava: the vision frontend stub
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _llava(kv):
    jm, jp, tm, tp = model_pair("llava-next-mistral-7b", kv_dtype=kv,
                                fused=True, **UNICAIM)
    n_front = tm.cfg.frontend_len
    tokens, length = _batch(tm.cfg.vocab_size, seed=5)
    vision = np.random.default_rng(6).standard_normal(
        (2, n_front, tm.cfg.d_model)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens), "length": jnp.asarray(length),
              "vision_embed": jnp.asarray(vision)}
    tbatch = {"tokens": torch.as_tensor(tokens),
              "length": torch.as_tensor(length),
              "vision_embed": torch.as_tensor(vision)}
    return jm, jp, tm, tp, jbatch, tbatch, length + n_front


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_llava_prefill_with_vision_embed_matches_reference(kv):
    jm, jp, tm, tp, jbatch, tbatch, steps = _llava(kv)
    jlog, jst = _prefill_fn(_model_key(jm))(jp, jbatch)
    tlog, tst = tm.prefill(tp, tbatch)
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(to_np(tst.kv.step), np.asarray(jst.kv.step))
    np.testing.assert_array_equal(to_np(tst.kv.step)[0], steps)
    # the embeddings matter: another vision_embed moves the logits
    other = dict(tbatch, vision_embed=tbatch["vision_embed"] * -1)
    assert float((tm.prefill(tp, other)[0] - tlog).abs().max()) > 1e-3


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_llava_greedy_tokens_equal_reference(kv):
    jm, jp, tm, tp, jbatch, tbatch, _ = _llava(kv)
    jtoks, _ = jax_greedy(jm, jp, jbatch, GREEDY_STEPS)
    ttoks, _ = greedy_generate(tm, tp, tbatch, GREEDY_STEPS, device="cpu")
    np.testing.assert_array_equal(to_np(ttoks), to_np(jtoks))


def test_frontend_model_refuses_chunked_prefill_and_serve_loop():
    jm, _, tm, tp, _, tbatch, _ = _llava("bf16")
    assert jm.supports_chunked_prefill() is tm.supports_chunked_prefill() \
        is False
    assert jm.supports_bucketed_prefill() is tm.supports_bucketed_prefill() \
        is True
    with pytest.raises(AssertionError):
        tm.init_prefill_chunk_state(1, 64)
    with pytest.raises(ValueError, match="vision_embed"):
        tm.prefill(tp, {"tokens": tbatch["tokens"]})
    with pytest.raises(ValueError, match="token prompts"):
        ServeLoop(tm, tp, lanes=2, chunk_prefill=16, device="cpu")
