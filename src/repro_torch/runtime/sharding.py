"""Logical-axis sharding rules with divisibility fallback — the port of
`repro/runtime/sharding.py`, plus the process-group side the reference
leaves to XLA.

Tensors are named by *logical* axes; a rule table maps each logical axis
to an ordered list of mesh-axis candidates. The first candidate that (a)
exists in the mesh and (b) evenly divides the dimension is chosen;
otherwise the dimension is replicated. A candidate that is a tuple shards
the dimension over the combined axes, the first axis major.

A "mesh" here is anything with a `shape` mapping from axis name to size:
a `ProcessMesh` (a `torch.distributed` DeviceMesh seen through its axis
names), the serving engine's `launch.mesh.LaneMesh`, or a plain dict in
the tests (a dict is its own shape), so the rules can be checked with no
process group. A spec is a tuple with the reference's `PartitionSpec`
entries — None, an axis name, or a tuple of axes — with trailing Nones
dropped, as `P(*out)` drops them.

`placements` turns a spec into DTensor `Shard(dim)` / `Replicate()`
placements, and `distribute` lays a tensor out with `distribute_tensor`.
The reference's `shard(x, *axes)` has no counterpart: its calls in the
model code only constrain XLA's layout propagation, and eager PyTorch has
no propagation to constrain. The paths that the reference runs under
`shard_map` (the slot-sharded decode, MLA's latent race, MoE's expert
parallelism, `compressed_psum`) call the collectives here by hand, through
`all_reduce`, `all_gather` and `all_to_all`, on the operands' own device:
a backend that refuses that device's tensors raises.
"""
from __future__ import annotations

import dataclasses
import threading
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import flatten_with_paths, unflatten

Spec = Tuple  # of None | str | Tuple[str, ...]

# logical axis → ordered mesh-axis candidates; a tuple candidate means the
# dim shards over the COMBINED axes (e.g. pod×data = 32-way DP)
DEFAULT_RULES: Tuple[Tuple[str, Tuple], ...] = (
    ("batch", (("pod", "data"), "data", "pod")),   # DP over pod×data
    ("fsdp", (("pod", "data"), "data")),           # ZeRO param/opt sharding
    ("seq", ()),                     # replicated by default (SP opt-in)
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("qdim", ("model",)),            # fused head*dh fallback axis
    ("ff", ("model",)),
    ("experts", ("model",)),
    ("vocab", ("model",)),
    ("d_model", ()),
    ("slots", ("model",)),           # long-context cache slot sharding
    ("stack", ()),                   # stacked layer axis — never sharded
)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a mesh: its `shape`, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(as_mesh(mesh).shape)


class ProcessMesh:
    """A `torch.distributed.device_mesh.DeviceMesh` seen through its axis
    names: `shape` {axis: size}, this rank's coordinate along one axis or
    a combination of axes, and the process group of that combination
    (the ranks that differ only along it)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        names = device_mesh.mesh_dim_names
        if names is None:
            raise ValueError("a ProcessMesh needs mesh_dim_names")
        self.names = tuple(names)
        self.shape = dict(zip(self.names, device_mesh.mesh.shape))
        self._groups: Dict[Tuple[str, ...], object] = {}

    @staticmethod
    def _axes(axes) -> Tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes) -> int:
        n = 1
        for a in self._axes(axes):
            n *= self.shape[a]
        return n

    def coord(self, axes) -> int:
        """This rank's index along `axes` combined, the first axis major."""
        mine = dict(zip(self.names, self.device_mesh.get_coordinate()))
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + mine[a]
        return i

    def group(self, axes):
        """The process group spanning `axes` (every rank calls this in the
        same order the first time a combination is used: a multi-axis
        group is made collectively)."""
        axes = self._axes(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            dims = [self.names.index(a) for a in axes]
            rest = [i for i in range(len(self.names)) if i not in dims]
            ranks = self.device_mesh.mesh.permute(rest + dims).reshape(
                -1, self.size(axes))
            mine, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
            self._groups[axes] = mine
        return self._groups[axes]

    def block_order(self, axes) -> Optional[Tuple[int, ...]]:
        """The block index along `axes` (their combined coordinate, the
        first axis major) of each rank of `group(axes)` in the group's rank
        order, which is the global ranks' order; None where the two agree.
        A group made of axes out of the mesh's order ranks its blocks
        otherwise."""
        axes = self._axes(axes)
        dims = [self.names.index(a) for a in axes]
        rest = [i for i in range(len(self.names)) if i not in dims]
        rows = self.device_mesh.mesh.permute(rest + dims).reshape(
            -1, self.size(axes)).tolist()
        me = dist.get_rank()
        row = next(r for r in rows if me in r)
        order = tuple(row.index(r) for r in sorted(row))
        return None if order == tuple(range(len(row))) else order


def as_mesh(mesh):
    """A DeviceMesh becomes a ProcessMesh; anything else is kept."""
    if mesh is None or isinstance(mesh, ProcessMesh):
        return mesh
    if hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group"):
        return ProcessMesh(mesh)
    return mesh


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules = dict(DEFAULT_RULES)


_CTX = _Ctx()


class use_mesh:
    """Context manager installing a mesh + optional rule overrides."""

    def __init__(self, mesh, **rule_overrides):
        self.mesh = as_mesh(mesh)
        self.rule_overrides = {k: tuple(v) if not isinstance(v, tuple) else v
                               for k, v in rule_overrides.items()}

    def __enter__(self):
        self._saved = (_CTX.mesh, dict(_CTX.rules))
        _CTX.mesh = self.mesh
        _CTX.rules.update(self.rule_overrides)
        return self.mesh

    def __exit__(self, *exc):
        _CTX.mesh, _CTX.rules = self._saved
        return False


def active_mesh():
    return _CTX.mesh


def active_process_mesh() -> Optional[ProcessMesh]:
    """The active mesh when it has process groups, else None."""
    mesh = _CTX.mesh
    return mesh if isinstance(mesh, ProcessMesh) else None


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _pick_axis(logical: str, dim: int, shape: Dict[str, int], used: set):
    """First viable candidate; tuple candidates shard over combined axes."""
    for cand in _CTX.rules.get(logical, ()):
        axes = cand if isinstance(cand, tuple) else (cand,)
        if any(a not in shape or a in used for a in axes):
            continue
        size = 1
        for a in axes:
            size *= shape[a]
        if size > 1 and dim % size == 0:
            return cand
    return None


def _trim(cols) -> Spec:
    cols = list(cols)
    while cols and cols[-1] is None:
        cols.pop()
    return tuple(cols)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int], mesh=None) -> Spec:
    """Map logical axis names (None = replicated) to a spec."""
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    used: set = set()
    out = []
    for name, dim in zip(logical_axes, shape):
        ax = _pick_axis(name, dim, sizes, used) if name else None
        if ax:
            used.update(ax if isinstance(ax, tuple) else (ax,))
        out.append(ax)
    return _trim(out)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` over `mesh` (a ProcessMesh or
    DeviceMesh): one per mesh axis, `Shard(dim)` for the axis a tensor
    dimension names, `Replicate()` otherwise. A dimension that names a
    tuple of axes is sharded over them in order (`Shard` on each: DTensor
    splits the dimension by the mesh axes in mesh order, so the tuple must
    follow the mesh's axis order)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = as_mesh(mesh)
    out = [Replicate() for _ in mesh.names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [mesh.names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {mesh.names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """A mesh and a spec: where `distribute` puts a tensor."""

    def __init__(self, mesh, spec: Spec):
        self.mesh = as_mesh(mesh)
        self.spec = spec

    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def apply(self, x: torch.Tensor):
        """`x`, the same global tensor on every rank, as a DTensor holding
        this rank's shard (no communication: every rank cuts its own)."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x, self.mesh.device_mesh, self.placements(),
                                 src_data_rank=None)


def named_sharding(logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int], mesh=None
                   ) -> Optional[NamedSharding]:
    mesh = as_mesh(mesh if mesh is not None else _CTX.mesh)
    if not isinstance(mesh, ProcessMesh):
        return None
    return NamedSharding(mesh, logical_to_spec(logical_axes, shape, mesh))


def distribute(x: torch.Tensor, axes: Sequence[Optional[str]], mesh=None):
    """Lay `x` out by logical `axes` on the (active) process mesh; `x`
    itself without one."""
    sh = named_sharding(axes, x.shape, mesh)
    return x if sh is None else sh.apply(x)


# ---------------------------------------------------------------------------
# Parameter / state sharding rules (path-name based)
# ---------------------------------------------------------------------------

# (substring-of-path, trailing logical axes). First match wins; extra leading
# dims (stacked layers) are padded with None ('stack').
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    ("embed", ("vocab", "fsdp")),
    ("lm_head", ("fsdp", "vocab")),
    ("frontend_adapter", ("fsdp", None)),
    ("mtp/proj", ("fsdp", None)),
    # attention
    ("attn/wq_a", ("fsdp", None)),
    ("attn/wkv_a", ("fsdp", None)),
    ("attn/wq_b", (None, "qdim")),
    ("attn/wkv_b", (None, "qdim")),
    ("attn/wq", ("fsdp", "qdim")),
    ("attn/wk", ("fsdp", "qdim")),
    ("attn/wv", ("fsdp", "qdim")),
    ("attn/wo", ("qdim", "fsdp")),
    ("xattn/wq", ("fsdp", "qdim")),
    ("xattn/wk", ("fsdp", "qdim")),
    ("xattn/wv", ("fsdp", "qdim")),
    ("xattn/wo", ("qdim", "fsdp")),
    # MoE (3D expert weights) before dense MLP rules
    ("moe/router", (None, None)),
    # experts → model when divisible (EP); otherwise the expert-ffn dim
    # takes the model axis (grok-1: 8 experts < 16-way model axis)
    ("moe/wi", ("experts", "fsdp", "ff")),
    ("moe/wg", ("experts", "fsdp", "ff")),
    ("moe/wo", ("experts", "ff", "fsdp")),
    ("moe/shared", ("fsdp", "ff")),      # overridden below for wo by order
    # dense MLP
    ("mlp/wi", ("fsdp", "ff")),
    ("mlp/wg", ("fsdp", "ff")),
    ("mlp/wo", ("ff", "fsdp")),
    # SSM
    ("ssm/in_proj", ("fsdp", "ff")),
    ("ssm/out_proj", ("ff", "fsdp")),
)


def param_logical_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Trailing-dim logical axes for a parameter leaf path like
    'seg0_moe/moe/wi'. Unmatched leaves are replicated."""
    # moe shared-expert wo needs the transposed rule
    if "moe/shared" in path and path.endswith("wo"):
        base: Tuple[Optional[str], ...] = ("ff", "fsdp")
    else:
        base = None
        for pat, axes in _PARAM_RULES:
            if pat in path:
                base = axes
                break
        if base is None:
            return (None,) * ndim
    if ndim < len(base):            # e.g. biases: replicate
        return (None,) * ndim
    return (None,) * (ndim - len(base)) + tuple(base)


def _map_with_paths(fn, tree):
    """`fn(path, leaf)` over a tree's leaves (the port's tree paths, or a
    dataclass's fields), keeping its structure."""
    flat = flatten_with_paths(tree, is_leaf=_is_state)
    out = []
    for path, leaf in flat:
        if _is_state(leaf):
            out.append(_state_map(fn, leaf, path))
        else:
            out.append(fn(path, leaf))
    return unflatten(tree, iter(out))


def _is_state(x) -> bool:
    """A decode-state dataclass (DecodeState, KVCache, SSMState)."""
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _state_map(fn, obj, path: str = ""):
    vals = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        p = f"{path}/{f.name}" if path else f.name
        if v is None:
            vals[f.name] = None
        elif _is_state(v):
            vals[f.name] = _state_map(fn, v, p)
        elif isinstance(v, (tuple, list)):
            vals[f.name] = type(v)(fn(f"{p}/{i}", x) for i, x in enumerate(v))
        else:
            vals[f.name] = fn(p, v)
    return type(obj)(**vals)


def params_pspecs(tree, mesh=None):
    """A tree of specs for a parameter/optimizer-state tree (tensors or
    anything with `shape`). An int8 moment's scale (size-1 trailing dim)
    fails divisibility and is replicated."""
    mesh = mesh if mesh is not None else _CTX.mesh

    def one(path, leaf):
        axes = param_logical_axes(path, len(leaf.shape))
        return logical_to_spec(axes, leaf.shape, mesh)

    return _map_with_paths(one, tree)


def params_shardings(tree, mesh=None):
    """NamedShardings for `params_pspecs` over a process mesh."""
    mesh = as_mesh(mesh if mesh is not None else _CTX.mesh)
    specs = params_pspecs(tree, mesh)
    return _map_specs(lambda s: NamedSharding(mesh, s), specs)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


# ---------------------------------------------------------------------------
# Decode-state (KV cache / SSM state) sharding
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    # KVCache fields: [L, B, Hk, S, d] / [L, B, Hk, S] / [L, B]
    "k": ("stack", "batch", "kv_heads", "slots", None),
    "v": ("stack", "batch", "kv_heads", "slots", None),
    "kq": ("stack", "batch", "kv_heads", "slots", None),
    "kscale": ("stack", "batch", "kv_heads", "slots"),
    "acc": ("stack", "batch", "kv_heads", "slots"),
    "valid": ("stack", "batch", "kv_heads", "slots"),
    "pos": ("stack", "batch", "kv_heads", "slots"),
    "fill": ("stack", "batch"),
    "step": ("stack", "batch"),
    # SSMState: conv [L,B,K-1,C], ssm [L,B,H,P,N]
    "conv": ("stack", "batch", None, "ff"),
    "ssm": ("stack", "batch", "heads", None, None),
}


def cache_logical_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes for DecodeState leaves (leading dim = layer stack)."""
    axes = _CACHE_AXES.get(path.rsplit("/", 1)[-1])
    if axes is None or len(axes) != ndim:
        return (None,) * ndim
    return axes


def lane_pspecs(tree, mesh, *, axis: int = 1):
    """Specs laying a stacked DecodeState out ``("data",)`` on the LANE
    axis only — the data-parallel serving layout.

    Every stacked decode-state tensor carries layers on axis 0 and lanes
    on axis 1, so each leaf shards axis `axis` over the mesh's ``data``
    axis and replicates everything else. Unlike `decode_state_pspecs`
    there is no fallback folding: lanes must divide the shard count
    (asserted), heads/slots stay whole per shard, and the decode block is
    collective-free — each shard owns a contiguous block of lanes end to
    end (cache, knobs, generators)."""
    n = int(mesh_shape(mesh)["data"])

    def one(path, leaf):
        assert len(leaf.shape) > axis and leaf.shape[axis] % n == 0, (
            f"lane axis {axis} of shape {tuple(leaf.shape)} not divisible "
            f"by {n}-way data mesh")
        cols: list = [None] * len(leaf.shape)
        cols[axis] = "data"
        return _trim(cols)

    return _map_with_paths(one, tree)


def decode_state_pspecs(tree, mesh=None):
    """Specs for a DecodeState.

    kv_heads shards over `model` when divisible; otherwise `slots` takes
    the model axis (flash-decode style). For batch-1 long-context cells
    every idle mesh axis is folded onto `slots`, so a long cache spreads
    over every card."""
    mesh = mesh if mesh is not None else _CTX.mesh
    sizes = None if mesh is None else mesh_shape(mesh)

    def one(path, leaf):
        ndim = len(leaf.shape)
        axes = list(cache_logical_axes(path, ndim))
        spec = logical_to_spec(axes, leaf.shape, mesh)
        cols = list(spec) + [None] * (ndim - len(spec))
        if sizes is not None and "slots" in axes:
            i_s = axes.index("slots")
            used = {c for c in cols if isinstance(c, str)}
            for c in cols:
                if isinstance(c, tuple):
                    used.update(c)
            combo = [cols[i_s]] if cols[i_s] else []
            for ax in ("model", "data", "pod"):
                if ax in used or ax not in sizes:
                    continue
                factor = 1
                for a in combo:
                    factor *= sizes[a]
                if leaf.shape[i_s] % (factor * sizes[ax]) == 0:
                    combo.append(ax)
                    used.add(ax)
            cols[i_s] = tuple(combo) if len(combo) > 1 else (
                combo[0] if combo else None)
        return _trim(cols)

    return _map_with_paths(one, tree)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """`x` reduced over `group` ("sum" or "max"); a new tensor."""
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = x.contiguous().clone()
    dist.all_reduce(out, op=rop, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's `x` in rank order of `group`."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n,) + tuple(x.shape))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out.view(-1), x.view(-1), group=group)
    return out


def gather_blocks(x: torch.Tensor, shard) -> torch.Tensor:
    """[n, *x.shape]: every rank's `x` over `shard.group` (a
    `core.cache.SlotShard`), in block order (`shard.order`)."""
    out = all_gather(x, shard.group)
    if shard.order is None:
        return out
    perm = [shard.order.index(b) for b in range(len(shard.order))]
    return out[torch.as_tensor(perm, device=out.device)]


def merge_shards(mz: torch.Tensor, num: torch.Tensor, mx: torch.Tensor,
                 den: torch.Tensor, group):
    """Two sets of a block's softmax statistics → the whole row's, over
    `group`, in one all-reduce of the maxima and one of the rescaled sums:
      mz [..., 2]: (max, sum of exp(x - max)) over this rank's block →
        the same over every rank's block (the row's softmax);
      num [..., dv], mx [...], den [...]: attention partials over the
        winners this rank holds (num = Σ exp(l - mx) v, den = Σ exp(l -
        mx); mx -inf, num and den 0 where it holds none) → out [..., dv]
        = Σ num w / Σ den w with w = exp(mx - M), M the maximum over the
        ranks: the flash-decode combine; 0 where no rank holds a valid
        winner.
    → (mz merged, out)."""
    m, z = mz[..., 0], mz[..., 1]
    tops = all_reduce(torch.cat([m.reshape(-1), mx.reshape(-1)]), "max",
                      group)
    top_m, top_x = tops[:m.numel()].view(m.shape), tops[m.numel():].view(
        mx.shape)

    def weight(x, top):
        return torch.where(x > -float("inf"), torch.exp(x - top),
                           torch.zeros_like(x))
    wz, wx = weight(m, top_m), weight(mx, top_x)
    sums = all_reduce(torch.cat([(z * wz).reshape(-1),
                                 (num * wx[..., None]).reshape(-1),
                                 (den * wx).reshape(-1)]), "sum", group)
    zs, nums, dens = torch.split(sums, [z.numel(), num.numel(), den.numel()])
    live = (top_x > -float("inf"))[..., None]
    out = torch.where(live, nums.view(num.shape) / torch.clamp(
        dens.view(den.shape)[..., None], min=1e-30), torch.zeros_like(num))
    return torch.stack([top_m, zs.view(z.shape)], dim=-1), out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of `x`'s first dim goes to rank i of `group`; chunk j of
    the result came from rank j (`x.shape[0]` divisible by the size)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out
