"""The port's sharding rules (`runtime/sharding.py`) against the
reference's, with no process group: a mesh is a plain {axis: size} dict on
the port's side and a jax AbstractMesh of the same shape on the
reference's. At the meshes of `tests/test_sharding.py` ((16, 16), (2, 16,
16), (2, 2)), every leaf's spec of reduced granite-3-2b, grok-1-314b and
deepseek-v3-671b params (the port's own init tree) and of their decode
states (and of the reference test's zamba2, starcoder2 and long-context
llava states) equals the reference's PartitionSpec entry for entry;
`lane_pspecs` too, with its divisibility assert; and the meshes' shape
logic (`launch/mesh.py`) is the reference's.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import PruneConfig as JaxPrune  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.runtime import sharding as jsh  # noqa: E402
from repro_torch.configs.base import PruneConfig, get_config, reduced  # noqa
from repro_torch.core import baselines  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.runtime import sharding as tsh  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SHAPES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def _fake_mesh(shape, axes):
    try:
        return jax.sharding.AbstractMesh(shape, axes)
    except TypeError:  # older jax: one tuple of (name, size) pairs
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))


def _meshes(name):
    shape, axes = SHAPES[name]
    return _fake_mesh(shape, axes), dict(zip(axes, shape))


def _ref_items(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jsh._path_str(path), tuple(s)) for path, s in flat]


def _port_items(specs, path=""):
    """(path, spec) of a spec tree: dicts, lists and the decode-state
    dataclasses, with tuples as leaves."""
    if specs is None:
        return []
    if dataclasses.is_dataclass(specs):
        items = [(f.name, getattr(specs, f.name))
                 for f in dataclasses.fields(specs)]
        if getattr(specs, "cross", None) is not None:   # an enc-dec pair
            items = [(k, list(v) if k == "cross" else v) for k, v in items]
    elif isinstance(specs, dict):
        items = sorted(specs.items())
    elif isinstance(specs, list):
        items = list(enumerate(specs))
    else:
        return [(path, specs)]
    out = []
    for k, v in items:
        out += _port_items(v, f"{path}/{k}" if path else str(k))
    return out


def _jprune(p) -> JaxPrune:
    return JaxPrune(**{f.name: getattr(p, f.name)
                       for f in dataclasses.fields(p)})


ARCHS = {
    "granite-3-2b": {},
    "grok-1-314b": dict(d_model=64, n_heads=16, n_kv_heads=16, head_dim=16),
    "deepseek-v3-671b": {},
}


def _pair(arch):
    prune = baselines.unicaim(heavy=48, reserve=16, select_k=16)
    jm = JaxModel(jax_reduced(jax_get_config(arch), **ARCHS[arch]),
                  _jprune(prune))
    tm = Model(reduced(get_config(arch), **ARCHS[arch]), prune,
               device="cpu")
    return jm, tm


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_the_reference(arch, mesh):
    jm, tm = _pair(arch)
    jmesh, tmesh_ = _meshes(mesh)
    with jsh.use_mesh(jmesh):
        want = _ref_items(jsh.params_pspecs(
            jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    got = _port_items(tsh.params_pspecs(tm.init(0), tmesh_))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert got == want
    assert any(s for _, s in got)          # something is sharded


def _state_pair(jcfg, tcfg, prune, slots, batch):
    jm = JaxModel(jcfg, _jprune(prune), decode_slots=slots)
    tm = Model(tcfg, dataclasses.replace(prune, heavy_budget=slots
                                         - prune.reserve), device="meta")
    jst = jax.eval_shape(lambda: jm.init_decode_state(batch))
    return jst, tm.init_decode_state(batch)


STATES = {
    # (arch, config overrides, prune, decode slots, batch)
    "zamba2-kv32": ("zamba2-7b", dict(n_kv_heads=32, n_heads=32,
                                      num_layers=12, attn_period=6),
                    PruneConfig(policy="unicaim", heavy_budget=1984,
                                reserve=64, select_k=64), 2048, 16),
    "starcoder2-kv2": ("starcoder2-3b", dict(n_kv_heads=2),
                       PruneConfig(policy="unicaim", heavy_budget=1984,
                                   reserve=64, select_k=64), 2048, 16),
    "llava-long": ("llava-next-mistral-7b", dict(n_kv_heads=2),
                   PruneConfig(policy="unicaim", heavy_budget=524224,
                               reserve=64, select_k=2048), 524288, 1),
    "granite-int8": ("granite-3-2b", {},
                     baselines.unicaim(heavy=48, reserve=16, select_k=16,
                                       kv_dtype="int8"), 64, 4),
    "deepseek-latent": ("deepseek-v3-671b", {},
                        baselines.unicaim(heavy=48, reserve=16,
                                          select_k=16), 64, 4),
}


@pytest.mark.parametrize("mesh", list(SHAPES))
@pytest.mark.parametrize("name", list(STATES))
def test_decode_state_specs_equal_the_reference(name, mesh):
    arch, kw, prune, slots, batch = STATES[name]
    jst, tst = _state_pair(jax_reduced(jax_get_config(arch), **kw),
                           reduced(get_config(arch), **kw), prune, slots,
                           batch)
    jmesh, tmesh_ = _meshes(mesh)
    with jsh.use_mesh(jmesh):
        want = _ref_items(jsh.decode_state_pspecs(jst))
    got = _port_items(tsh.decode_state_pspecs(tst, tmesh_))
    assert got == want


def test_reference_cases_hold_on_the_port():
    """The reference test's named claims, on the port's rules."""
    m16, m3 = _meshes("16x16")[1], _meshes("2x16x16")[1]
    assert tsh.logical_to_spec(("heads",), (24,), m16) == ()
    assert tsh.logical_to_spec(("heads",), (32,), m16) == ("model",)
    assert tsh.logical_to_spec(("batch", None), (256, 10), m3) == (
        ("pod", "data"),)
    assert tsh.logical_to_spec(("batch", None), (256, 10), m16) == ("data",)
    arch, kw, prune, slots, batch = STATES["llava-long"]
    _, tst = _state_pair(jax_reduced(jax_get_config(arch), **kw),
                         reduced(get_config(arch), **kw), prune, slots, batch)
    # batch 1 cannot shard: slots fold model AND the idle data axis
    assert tsh.decode_state_pspecs(tst, m16).kv.k[3] == ("model", "data")
    with tsh.use_mesh(m16):
        assert tsh.active_mesh() == m16
        assert tsh.logical_to_spec(("heads",), (32,)) == ("model",)
    assert tsh.active_mesh() is None
    assert tsh.logical_to_spec(("heads",), (32,)) == ()


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_lane_specs_equal_the_reference(shards):
    arch, kw, prune, slots, batch = STATES["granite-int8"]
    jst, tst = _state_pair(jax_reduced(jax_get_config(arch), **kw),
                           reduced(get_config(arch), **kw), prune, slots,
                           batch)
    jmesh = _fake_mesh((shards,), ("data",))
    want = _ref_items(jsh.lane_pspecs(jst, jmesh))
    got = _port_items(tsh.lane_pspecs(tst, tmesh.LaneMesh(["cpu"] * shards)))
    assert got == want
    assert all(s[:2] == (None, "data") for _, s in got)


def test_lane_specs_assert_divisibility():
    arch, kw, prune, slots, batch = STATES["granite-int8"]   # 4 lanes
    _, tst = _state_pair(jax_reduced(jax_get_config(arch), **kw),
                         reduced(get_config(arch), **kw), prune, slots, batch)
    with pytest.raises(AssertionError):
        tsh.lane_pspecs(tst, {"data": 3})


def test_param_logical_axes_equal_the_reference():
    paths = ["seg0_moe/moe/wi", "seg0_moe/moe/shared/0/wo",
             "seg0_moe/moe/shared/0/wi", "seg0_dense/attn/bq", "embed",
             "lm_head", "seg0_ssm/ssm/in_proj", "seg1_mla_moe/attn/wkv_b",
             "final_norm/w", "mtp/proj", "seg1_encdec_dec/xattn/wo"]
    for path in paths:
        for ndim in (1, 2, 3, 4):
            assert (tsh.param_logical_axes(path, ndim)
                    == jsh.param_logical_axes(path, ndim)), (path, ndim)
    for name in ("k", "kq", "kscale", "acc", "fill", "conv", "ssm", "vscale"):
        for ndim in (2, 4, 5):
            assert (tsh.cache_logical_axes(f"kv/{name}", ndim)
                    == jsh.cache_logical_axes(f"kv/{name}", ndim))


def test_mesh_shape_logic_equals_the_reference():
    """`make_production_mesh` / `make_elastic_mesh` need a world of 256 /
    512 / n ranks: their shape logic is checked against the reference's
    source of it (launch/mesh.py)."""
    assert tmesh.production_mesh_shape(False) == ((16, 16),
                                                  ("data", "model"))
    assert tmesh.production_mesh_shape(True) == ((2, 16, 16),
                                                 ("pod", "data", "model"))
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 256, 512):
        model = next(c for c in (16, 8, 4, 2, 1) if n % c == 0)
        assert tmesh.elastic_mesh_shape(n) == (n // model, model)
    lm = tmesh.make_serve_mesh(3, device="cpu")
    assert lm.shape == {"data": 3} and lm.size == 3
    assert all(d.type == "cpu" for d in lm.devices)
    with pytest.raises(RuntimeError):        # entry points need the card
        tmesh.make_serve_mesh(2)


def test_placements_name_the_spec():
    """Specs become DTensor placements over a mesh's axes (the mesh only
    needs its axis names here)."""
    from torch.distributed.tensor import Replicate, Shard

    class Fake:
        names = ("data", "model")
    fake = Fake()
    assert tsh.placements((), fake) == (Replicate(), Replicate())
    assert tsh.placements((None, "model"), fake) == (Replicate(), Shard(1))
    assert tsh.placements(("data", "model"), fake) == (Shard(0), Shard(1))
    assert tsh.placements((("data", "model"),), fake) == (Shard(0),
                                                          Shard(0))
    with pytest.raises(ValueError):
        tsh.placements((("model", "data"),), fake)
    assert np.all([isinstance(p, Replicate)
                   for p in tsh.placements((None, None), fake)])
