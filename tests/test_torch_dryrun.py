"""The port's analytic dry run (`launch/dryrun.py`) against the reference's
`repro/launch/dryrun.py`, on the CPU.

- `make_prune` for every shape x option, `cost_basis`'s full counts and
  its probes' layer counts for all ten archs, and `cell_notes`' text;
- per-device argument bytes, by tree (params, AdamW's state, the decode
  state, the batch): the reference's side is reckoned from
  `jax.eval_shape` of its `Model.init`, `init_decode_state` and
  `adamw.init` and its own `params_pspecs` / `decode_state_pspecs` under
  a jax `AbstractMesh`, the port's from its `meta` trees and a plain
  {axis: size} dict. They are held equal, to the byte, for every arch x
  shape at (16, 16) and (2, 16, 16): at the 2- and 3-layer probe depths
  and, for the port's extrapolated count, against the reference's
  full-depth trees; and the extrapolation against the port's own
  full-depth count for longchat-7b and mamba2-1.3b;
- `Model(device="meta")` builds the trees of the CPU (paths, shapes,
  dtypes) with no storage, and the CPU draws are pinned;
- the CLI writes a record that the report prints.

The reference's dry run raises the host device count through `XLA_FLAGS`
when it is imported; the test imports it with that variable restored
afterwards, so no backend of this process sees 512 devices.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import PruneConfig as JaxPrune  # noqa: E402
from repro.configs.base import SHAPES_BY_NAME as JAX_SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch.train import TrainState as JaxTrainState  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import sharding as jsh  # noqa: E402
from repro_torch.configs.base import SHAPES, get_config, reduced  # noqa
from repro_torch.core import baselines  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

jax.config.update("jax_platform_name", "cpu")

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
OPTS = [(), ("blocks4",), ("kvint8",), ("blocks4", "kvint8")]


def test_arch_lists_equal_the_reference():
    assert dryrun.ARCHS == jdry.ARCHS
    assert dryrun._BIG == jdry._BIG
    # `--arch all` and the report's rows add the port's served model
    assert dryrun.ALL_ARCHS == jdry.ARCHS + ["longchat-7b"]
    assert report.ARCH_ORDER == dryrun.ALL_ARCHS


@pytest.mark.parametrize("opt", ["blocks4", "rematdots", "losschunk4",
                                 "chunk512", "moeep"])
def test_uncounted_options_are_refused(opt, tmp_path):
    """Only kvint8 changes a counted byte; the reference's other variants
    change only compiled costs, so a record under their tag would repeat
    the base cell's numbers."""
    shape = dryrun.SHAPES_BY_NAME["decode_32k"]
    with pytest.raises(ValueError, match="changes no counted byte"):
        dryrun.build_cell(get_config("longchat-7b"), shape, opts=(opt,))
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "longchat-7b", "--shape", "decode_32k",
                     "--opt", f"kvint8,{opt}", "--out", str(tmp_path)])
    assert e.value.code == 2 and not os.listdir(tmp_path)


@pytest.mark.parametrize("opts", OPTS, ids=lambda o: "+".join(o) or "none")
def test_make_prune_equals_the_reference(opts):
    for s in SHAPES:
        for policy in ("unicaim", "h2o", "dense"):
            got = dryrun.make_prune(s, policy, opts)
            want = jdry.make_prune(JAX_SHAPES[s.name], policy, opts)
            for f in dataclasses.fields(got):
                assert getattr(got, f.name) == getattr(want, f.name), f.name


def _depths(cfg):
    moe = getattr(cfg, "moe", None)
    return (cfg.num_layers, cfg.enc_layers, cfg.dec_layers,
            moe.dense_first_k if moe else None)


def _probe_counts(full):
    base = {k: 2 for k in full}
    return [base] + [dict(base, **{d: 3}) for d in full]


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_cost_basis_equals_the_reference(arch):
    make, full = dryrun.cost_basis(get_config(arch))
    jmake, jfull = jdry.cost_basis(jax_get_config(arch))
    assert full == jfull
    for counts in _probe_counts(full) + [full]:
        assert _depths(make(counts)) == _depths(jmake(counts))
    for s in SHAPES:
        assert dryrun.cell_notes(arch, s) == jdry.cell_notes(
            arch, JAX_SHAPES[s.name])


def _ways(spec, sizes):
    n = 1
    for entry in spec:
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            n *= sizes[ax]
    return n


def _ref_tree_bytes(tree, specs, sizes):
    shapes = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(shapes) == len(spec_leaves)
    return sum(int(np.prod(s.shape)) * s.dtype.itemsize // _ways(p, sizes)
               for s, p in zip(shapes, spec_leaves))


def _ref_cfg(arch, counts):
    cfg = jax_get_config(arch)
    return cfg if counts is None else jdry.cost_basis(cfg)[0](dict(counts))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, counts):
    """The reference's parameter shapes (they depend on no cell knob)."""
    model = JaxModel(_ref_cfg(arch, counts), JaxPrune())
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _ref_trees(arch, counts, shape_name, opts):
    """The reference dry run's argument trees (shapes only) of one cell at
    the layer counts `counts` (None: full depth)."""
    cfg = _ref_cfg(arch, counts)
    shape = JAX_SHAPES[shape_name]
    prune = jdry.make_prune(shape, "unicaim", opts)
    b = shape.global_batch
    params = _ref_params(arch, counts)
    trees = {"params": params}
    t = shape.seq_len
    if shape.kind == "train":
        # the full model's moments at every depth, as the reference's
        # argument bytes come from its full-depth compile
        opt_cfg = jadamw.AdamWConfig(
            quantized_state=jax_get_config(arch).param_count() > 2e10)
        trees["train_state"] = JaxTrainState(
            params=params,
            opt=jax.eval_shape(lambda p: jadamw.init(p, opt_cfg), params),
            step=jax.ShapeDtypeStruct((), jnp.int32))
    if shape.kind == "decode":
        model = JaxModel(cfg, prune, decode_slots=shape.seq_len)
        cross = cfg.frontend_len if cfg.family == "encdec" else 0
        trees["state"] = jax.eval_shape(
            lambda: model.init_decode_state(b, cross_len=cross))
        trees["batch"] = {"tokens": jax.ShapeDtypeStruct((b,), jnp.int32)}
    else:
        bs = {"tokens": jax.ShapeDtypeStruct((b, t), jnp.int32)}
        if cfg.family == "encdec":
            bs["enc_embed"] = jax.ShapeDtypeStruct(
                (b, cfg.frontend_len, cfg.d_model), jnp.bfloat16)
        elif cfg.frontend != "none":
            bs[f"{cfg.frontend}_embed"] = jax.ShapeDtypeStruct(
                (b, cfg.frontend_len, cfg.d_model), jnp.bfloat16)
        trees["batch"] = bs
    return trees


def _fake_mesh(shape, axes):
    try:
        return jax.sharding.AbstractMesh(shape, axes)
    except TypeError:  # older jax: one tuple of (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


def _ref_parts(arch, counts, shape_name, multi_pod, opts=()):
    """The reference's per-device argument bytes by tree, as the port's
    `dryrun.arg_bytes` splits them."""
    trees = _ref_trees(arch, None if counts is None else
                       tuple(sorted(counts.items())), shape_name, opts)
    shape, axes = MESHES[multi_pod]
    sizes = dict(zip(axes, shape))
    overrides = {}
    if JAX_SHAPES[shape_name].kind != "train" and arch not in jdry._BIG:
        overrides["fsdp"] = ()
    with jsh.use_mesh(_fake_mesh(shape, axes), **overrides):
        parts = {"params": _ref_tree_bytes(
            trees["params"], jsh.params_pspecs(trees["params"]), sizes)}
        if "train_state" in trees:
            st = trees["train_state"]
            parts["opt"] = _ref_tree_bytes(
                st, jsh.params_pspecs(st), sizes) - parts["params"]
        if "state" in trees:
            parts["state"] = _ref_tree_bytes(
                trees["state"], jsh.decode_state_pspecs(trees["state"]),
                sizes)
        bspecs = {k: jsh.logical_to_spec(
            ("batch",) + (None,) * (len(v.shape) - 1), v.shape)
            for k, v in trees["batch"].items()}
        parts["batch"] = _ref_tree_bytes(trees["batch"], bspecs, sizes)
    return parts


def _port_parts(arch, counts, shape_name, multi_pod, opts=()):
    full = get_config(arch)
    cfg = full if counts is None else dryrun.cost_basis(full)[0](counts)
    shape, axes = MESHES[multi_pod]
    cell = dryrun.build_cell(cfg, dryrun.SHAPES_BY_NAME[shape_name],
                             opts=opts,
                             quantized_state=full.param_count() > 2e10)
    return dryrun.arg_bytes(cell, dict(zip(axes, shape)))


CELLS = [(a, mp) for a in dryrun.ARCHS for mp in (False, True)]


@pytest.mark.parametrize("arch,multi_pod", CELLS,
                         ids=[f"{a}-{'2x16x16' if mp else '16x16'}"
                              for a, mp in CELLS])
def test_arg_bytes_equal_the_reference(arch, multi_pod):
    _, full = dryrun.cost_basis(get_config(arch))
    mesh = dict(zip(MESHES[multi_pod][1], MESHES[multi_pod][0]))
    for s in SHAPES:
        for counts in _probe_counts(full):
            assert _port_parts(arch, counts, s.name, multi_pod) == \
                _ref_parts(arch, counts, s.name, multi_pod), (s.name, counts)
        got = dryrun.probe_arg_bytes(get_config(arch), s, mesh)
        want = _ref_parts(arch, None, s.name, multi_pod)
        assert got == want, s.name
        assert got["params"] > 0 and got["batch"] > 0


def test_int8_kv_decode_bytes_equal_the_reference():
    for arch in ("granite-3-2b", "deepseek-v3-671b", "whisper-base"):
        for mp in (False, True):
            mesh = dict(zip(MESHES[mp][1], MESHES[mp][0]))
            got = dryrun.probe_arg_bytes(
                get_config(arch), dryrun.SHAPES_BY_NAME["decode_32k"], mesh,
                opts=("kvint8",))
            assert got == _ref_parts(arch, None, "decode_32k", mp,
                                     ("kvint8",))


@pytest.mark.parametrize("arch", ["longchat-7b", "mamba2-1.3b"])
def test_extrapolated_bytes_equal_a_full_depth_count(arch):
    cfg = get_config(arch)
    for s in SHAPES:
        for mp in (False, True):
            mesh = dict(zip(MESHES[mp][1], MESHES[mp][0]))
            direct = dryrun.arg_bytes(dryrun.build_cell(cfg, s), mesh)
            assert dryrun.probe_arg_bytes(cfg, s, mesh) == direct
            assert direct == _ref_parts(arch, None, s.name, mp)


def test_step_read_bytes_count_the_winners_k_v_rows():
    """A decode step under unicaim's top-k race reads the K/V rows of
    select_k of each (lane, kv head)'s slots, the rest of the state whole;
    other cells and policies read their arguments whole."""
    cfg = get_config("longchat-7b")
    mesh = dict(zip(MESHES[False][1], MESHES[False][0]))
    shape = dryrun.SHAPES_BY_NAME["decode_32k"]
    cell = dryrun.build_cell(cfg, shape)
    args = dryrun.arg_bytes(cell, mesh)
    read = dryrun.step_read_bytes(cell, mesh, args)
    s, k = shape.seq_len, cell.model.prune.select_k
    assert (s, k) == (32768, 2048)
    # bf16 K and V of 32 layers x 128 lanes x 32 heads x 128 wide, over
    # the 256 devices (lanes on data, heads on model)
    rows = 2 * 32 * 128 * 32 * s * 128 * 2 // 256
    assert read == dict(args, state=args["state"] - rows * (s - k) // s)
    # int8 K is the mirror: read whole; V and its scales by winners only
    cell8 = dryrun.build_cell(cfg, shape, opts=("kvint8",))
    args8 = dryrun.arg_bytes(cell8, mesh)
    read8 = dryrun.step_read_bytes(cell8, mesh, args8)
    assert cell8.model.init_decode_state(cell8.batch).kv.kq is None
    # int8 V is a quarter of the bf16 K and V; V's f32 scales have no
    # sharding rule (as in the reference), so each device holds them whole
    v8, vscale = rows // 4, 32 * 128 * 32 * s * 4
    assert read8 == dict(args8, state=args8["state"]
                         - (v8 + vscale) * (s - k) // s)
    for other in (dryrun.build_cell(cfg, shape, policy="h2o"),
                  dryrun.build_cell(cfg, dryrun.SHAPES_BY_NAME["prefill_32k"]),
                  dryrun.build_cell(cfg, dryrun.SHAPES_BY_NAME["train_4k"])):
        parts = dryrun.arg_bytes(other, mesh)
        assert dryrun.step_read_bytes(other, mesh, parts) == parts
    ssm = dryrun.build_cell(get_config("mamba2-1.3b"), shape)
    parts = dryrun.arg_bytes(ssm, mesh)
    assert dryrun.step_read_bytes(ssm, mesh, parts) == parts


def _signature(tree):
    """(path, shape, dtype) of every leaf; a decode state's dataclasses by
    field."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: _fields(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return [(p, tuple(x.shape), x.dtype)
            for p, x in flatten_with_paths(tree)]


def _fields(x):
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return x


META_ARCHS = ["granite-3-2b", "grok-1-314b", "deepseek-v3-671b",
              "zamba2-7b", "whisper-base", "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", META_ARCHS)
def test_meta_trees_match_the_cpu_trees(arch):
    kw = {"zamba2-7b": {"num_layers": 5}}.get(arch, {})
    cfg = reduced(get_config(arch), **kw)
    prune = baselines.unicaim(heavy=48, reserve=16, select_k=16)
    cpu, meta = Model(cfg, prune, device="cpu"), Model(cfg, prune,
                                                       device="meta")
    pc, pm = cpu.init(0), meta.init(0)
    assert _signature(pm) == _signature(pc)
    assert all(x.is_meta for _, x in flatten_with_paths(pm))
    for q in (False, True):
        oc = adamw.init(pc, adamw.AdamWConfig(quantized_state=q))
        om = adamw.init(pm, adamw.AdamWConfig(quantized_state=q))
        assert _signature(om) == _signature(oc)
        assert all(x.is_meta for _, x in flatten_with_paths(om))
    cross = cfg.frontend_len if cfg.family == "encdec" else 0
    sc = cpu.init_decode_state(3, cross_len=cross)
    sm = meta.init_decode_state(3, cross_len=cross)
    assert _signature(sm) == _signature(sc)
    assert all(x.is_meta for _, x in _signature_leaves(sm))


def _signature_leaves(state):
    return flatten_with_paths({f.name: _fields(getattr(state, f.name))
                               for f in dataclasses.fields(state)})


def test_full_width_meta_trees_hold_no_storage():
    for arch in dryrun.ARCHS:
        cfg = get_config(arch)
        model = Model(cfg, dryrun.make_prune(
            dryrun.SHAPES_BY_NAME["decode_32k"]), device="meta")
        params = model.init(0)
        flat = flatten_with_paths(params)
        assert all(x.is_meta for _, x in flat)
        n = sum(x.numel() for _, x in flat)
        # the tree's count within 1% of the config's analytic count (the
        # latter leaves out small leaves such as biases and routers)
        assert abs(n - cfg.param_count()) <= 0.01 * n, arch
        opt = adamw.init(params, adamw.AdamWConfig(quantized_state=True))
        assert all(x.is_meta for _, x in flatten_with_paths(opt))
        cross = cfg.frontend_len if cfg.family == "encdec" else 0
        st = model.init_decode_state(4, cross_len=cross)
        assert all(x.is_meta for _, x in _signature_leaves(st))


# SHA-256 of reduced granite-3-2b's and deepseek-v3-671b's init(0) trees on
# the CPU (every leaf's bytes in tree order): the draws that the port's
# parity tests and checkpoints rest on
CPU_DRAWS = {
    "granite-3-2b":
        "5e7cff15a98c25ac18d61f358f5a039f455c246aeba75c89090458ac6532d1af",
    "deepseek-v3-671b":
        "a2a3b5d83ac8c31e1dbf1e29b87fa763cc4d99c030bdab353d9b4bc3bc7a78d2",
}


@pytest.mark.parametrize("arch", list(CPU_DRAWS))
def test_cpu_draws_are_pinned(arch):
    model = Model(reduced(get_config(arch)),
                  baselines.unicaim(heavy=48, reserve=16, select_k=16),
                  device="cpu")
    params = model.init(0)
    h = hashlib.sha256()
    for _, x in flatten_with_paths(params):
        h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == CPU_DRAWS[arch]
    gen = torch.Generator().manual_seed(0)
    embed = torch.randn(params["embed"].shape, generator=gen) * 0.02
    assert torch.equal(params["embed"], embed.to(params["embed"].dtype))


def test_cli_writes_a_record_that_the_report_prints(tmp_path, capsys):
    out = str(tmp_path)
    argv = ["--arch", "longchat-7b", "--shape", "decode_32k", "--mesh",
            "single", "--out", out]
    assert dryrun.main(argv) == 0
    with open(tmp_path / "longchat-7b_decode_32k_single.json") as f:
        rec = json.load(f)
    assert rec["cost_source"] == "analytic" and rec["n_devices"] == 256
    for k in ("peak_bytes_per_dev", "temp_bytes_per_dev",
              "output_bytes_per_dev", "collective_bytes", "collectives",
              "useful_flops_ratio", "compile_s", "probe_s", "collective_s"):
        assert rec[k] is None, k
    assert rec["arg_bytes_per_dev"] == sum(rec["arg_bytes_parts"].values())
    assert rec["bytes_accessed"] == sum(rec["bytes_accessed_parts"].values())
    assert rec["bytes_accessed"] < rec["arg_bytes_per_dev"]   # winners' K/V
    assert rec["flops"] * 256 == rec["model_flops"]
    assert rec["dominant"] == "memory_s"
    assert dryrun.main(argv) == 0                 # an existing record skips
    capsys.readouterr()
    report.main(["--dir", out])
    text = capsys.readouterr().out
    rows = [ln for ln in text.splitlines() if ln.startswith("| longchat-7b")]
    assert len(rows) == 2                         # dry-run and roofline
    assert rows[0].startswith("| longchat-7b | decode_32k | n/a | ")
    assert "**memory**" in rows[1]
