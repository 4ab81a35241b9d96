"""Analytic dry run over the production meshes — the port of
`repro/launch/dryrun.py`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch longchat-7b --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.report --dir experiments/dryrun_torch

For every (architecture × input shape) cell, on the 16×16 single-pod mesh
and the 2×16×16 multi-pod mesh (`launch/mesh.production_mesh_shape`, a
plain {axis: size} dict with no process group), it writes one JSON record
in the reference's layout. Nothing is allocated on any device and no card
is needed: the step's arguments are shape-only trees on `meta`.

The reference lowers and compiles the step on 512 fake host devices and
reads XLA's `memory_analysis` and `cost_analysis` and the compiled HLO's
collective bytes. Eager PyTorch compiles no program, so this dry run is
analytic, and its cost model is `COST_MODEL` below:

- `arg_bytes_per_dev`: each argument leaf's bytes over the mesh sizes of
  its spec (`runtime/sharding.params_pspecs` / `decode_state_pspecs`, the
  batch on its `batch` axis): the parameters; for train, AdamW's state
  (int8 moments when the model holds more than 2e10 parameters) and the
  step; for decode, the decode state at `shape.seq_len` slots (with the
  cross K/V over `frontend_len` rows for an enc-dec model) and the
  token; and the batch. Tokens are counted as int32, as the reference's
  step takes them. Bytes are affine in the layer counts that
  `cost_basis` names, so they come, as the reference's costs do, from
  trees at 2 and 3 layers a dimension, extrapolated.
- `flops`: `roofline.model_flops` spread evenly over the devices.
- `bytes_accessed` (split in `bytes_accessed_parts`): the per-device
  bytes a step reads. For a train or prefill cell, the argument bytes,
  each read once. For a decode cell, the same but for the cache's K/V
  rows under unicaim's top-k race (`step_read_bytes`): the step reads
  the whole low-bit mirror, its scales and the acc, valid and pos
  tables, but the K/V rows of only `select_k` winners of each (lane, kv
  head), counted as select_k/slots of each device's rows (the winners
  spread evenly over the slot shards). A policy that attends to every
  held row reads them all. Writes are not counted, so this stays a
  lower bound on a step's traffic.
- The fields that only a compiled program gives — `peak_bytes_per_dev`,
  `temp_bytes_per_dev`, `output_bytes_per_dev`, `collective_bytes`,
  `collectives`, `useful_flops_ratio`, `compile_s` and `probe_s` — are
  None, and the record says so (`cost_source`, `cost_note`); `count_s` is
  the analytic count's wall time. So the roofline has no collective term.

`runtime/flags.py` (`unroll_scans`, `xscan`) and `runtime/compat.py` (a
jax `shard_map` shim) have no counterpart in the port: its layer and chunk
loops are eager Python, which has no scan to unroll, and its collectives
call `torch.distributed` directly.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import (PruneConfig, ShapeConfig, SHAPES,
                                      SHAPES_BY_NAME, get_config)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.launch.train import TrainState
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.runtime.sharding import (decode_state_pspecs,
                                          logical_to_spec, mesh_shape,
                                          params_pspecs, use_mesh)

ARCHS = [
    "whisper-base", "minitron-8b", "starcoder2-3b", "phi3-medium-14b",
    "granite-3-2b", "deepseek-v3-671b", "grok-1-314b", "zamba2-7b",
    "mamba2-1.3b", "llava-next-mistral-7b",
]
# `--arch all` and the report's rows: the reference's ten and the port's
# served model
ALL_ARCHS = ARCHS + ["longchat-7b"]

# archs whose bf16 params exceed ~8 GB/chip under TP-16 alone → keep ZeRO
# (fsdp) sharding even for inference cells (per-layer all-gather).
_BIG = {"deepseek-v3-671b", "grok-1-314b"}

COST_MODEL = ("analytic: flops = model_flops spread evenly over the "
              "devices; bytes_accessed = the per-device bytes a step "
              "reads: the argument bytes read once, but for a decode "
              "cell under unicaim's top-k race only select_k/slots of the "
              "cache's K/V rows (the mirror, scales and tables in full); "
              "peak/temp/output bytes, collective bytes and their mix, "
              "useful_flops_ratio, compile_s and probe_s come from a "
              "compiled program, which eager PyTorch does not make, and "
              "are None")

# the --opt variants that change a counted byte; the reference's others
# (blocksN, rematdots, losschunkN, chunkN, moeep) change only what its
# compiler measures, which this model has no counterpart of
COUNTED_OPTS = ("kvint8",)


def check_opts(opts) -> None:
    """Refuse an option whose effect the analytic model cannot count."""
    for o in opts:
        if o not in COUNTED_OPTS:
            raise ValueError(
                f"option {o!r} changes no counted byte: the analytic dry run "
                f"has no compiled cost for it (counted: "
                f"{', '.join(COUNTED_OPTS)})")


def cell_notes(arch: str, shape: ShapeConfig) -> str:
    notes = []
    cfg = get_config(arch)
    if cfg.family == "ssm":
        notes.append("UniCAIM inapplicable (no KV cache); native O(1)-state "
                     "decode — see DESIGN.md §Arch-applicability")
    if cfg.family == "hybrid":
        notes.append("UniCAIM applies to the shared-attention caches only")
    if shape.name == "long_500k" and cfg.has_attention:
        notes.append("500k decode runs WITH UniCAIM dynamic pruning (dense "
                     "full-attention variant skipped as intractable — the "
                     "technique is what makes this cell feasible)")
    if arch == "whisper-base" and shape.kind != "train":
        notes.append("decoder stress config (real model ctx=448); "
                     "conv frontend stubbed to frame embeddings")
    return "; ".join(notes)


def make_prune(shape: ShapeConfig, policy: str = "unicaim",
               opts=()) -> PruneConfig:
    blocks = 1
    kv_dtype = "bf16"
    for o in opts:
        if o.startswith("blocks"):
            blocks = int(o[6:])
        if o == "kvint8":
            kv_dtype = "int8"
    if shape.kind == "decode":
        slots = shape.seq_len
        return PruneConfig(
            policy=policy, heavy_budget=slots - 64, reserve=64,
            sink_tokens=4, recent_window=64,
            select_k=min(2048, slots // 16), score_bits=3, query_bits=4,
            select_blocks=blocks, kv_dtype=kv_dtype)
    if shape.kind == "prefill":
        heavy = max(shape.seq_len // 8, 512)
        return PruneConfig(policy=policy, heavy_budget=heavy, reserve=64,
                           sink_tokens=4, recent_window=64,
                           select_k=min(1024, heavy // 4))
    return PruneConfig(policy=policy)        # train: cache-free


def cost_basis(cfg):
    """(make(counts)→cfg, full_counts): the layer-count knobs in which a
    cell's argument bytes are affine — the dry run counts shallow variants
    and extrapolates, as the reference does for its compiled costs."""
    if cfg.family == "mla_moe":
        full = {"dense": cfg.moe.dense_first_k,
                "moe": cfg.num_layers - cfg.moe.dense_first_k}

        def make(c):
            return dataclasses.replace(
                cfg, num_layers=c["dense"] + c["moe"],
                moe=dataclasses.replace(cfg.moe, dense_first_k=c["dense"]))
    elif cfg.family == "encdec":
        full = {"enc": cfg.enc_layers, "dec": cfg.dec_layers}

        def make(c):
            return dataclasses.replace(cfg, enc_layers=c["enc"],
                                       dec_layers=c["dec"])
    elif cfg.family == "hybrid":
        period = cfg.attn_period
        full = {"group": cfg.num_layers // period,
                "tail": cfg.num_layers % period}

        def make(c):
            return dataclasses.replace(
                cfg, num_layers=c["group"] * period + c["tail"])
        if full["tail"] == 0:
            full.pop("tail")
    else:
        full = {"layers": cfg.num_layers}

        def make(c):
            return dataclasses.replace(cfg, num_layers=c["layers"])
    return make, full


class Cell(NamedTuple):
    """One cell's step on `meta`: its model, kind, global batch and
    sequence length, AdamW's settings (train) and the cross K/V rows
    (enc-dec decode)."""
    model: Model
    kind: str
    batch: int
    seq_len: int
    opt_cfg: Optional[adamw.AdamWConfig]
    cross_len: int


def build_cell(cfg, shape: ShapeConfig, policy: str = "unicaim", opts=(),
               prune: PruneConfig = None,
               quantized_state: Optional[bool] = None) -> Cell:
    """The cell's model on `meta` and its step's settings. opts: the
    `COUNTED_OPTS` ('kvint8': int8 K/V); any other raises. `prune`
    replaces `make_prune`'s; `quantized_state` (int8 moments) defaults to
    `cfg` holding more than 2e10 parameters."""
    check_opts(opts)
    prune = prune or make_prune(shape, policy, opts)
    opt_cfg = cross = None
    if shape.kind == "train":
        model = Model(cfg, prune, device="meta")
        if quantized_state is None:
            quantized_state = cfg.param_count() > 2e10
        opt_cfg = adamw.AdamWConfig(quantized_state=quantized_state)
    else:
        if shape.kind == "decode" and prune.slots != shape.seq_len:
            raise ValueError(f"a decode cell holds {shape.seq_len} slots; "
                             f"the pruning has {prune.slots}")
        model = Model(cfg, prune, device="meta")
        cross = cfg.frontend_len if cfg.family == "encdec" else 0
    return Cell(model, shape.kind, shape.global_batch, shape.seq_len,
                opt_cfg, cross or 0)


def _ways(spec, sizes: Dict[str, int]) -> int:
    n = 1
    for entry in spec:
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            n *= sizes[ax]
    return n


def tree_bytes_per_dev(tree, specs, sizes: Dict[str, int]) -> int:
    """Bytes a device holds of a tree of tensors (dicts, lists, NamedTuples
    and the decode state's dataclasses) laid out by `specs`, a spec tree
    of the same structure."""
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() // _ways(specs, sizes)
    if isinstance(tree, dict):
        return sum(tree_bytes_per_dev(v, specs[k], sizes)
                   for k, v in tree.items())
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes_per_dev(getattr(tree, f.name),
                                      getattr(specs, f.name), sizes)
                   for f in dataclasses.fields(tree))
    return sum(tree_bytes_per_dev(v, s, sizes)
               for v, s in zip(tree, specs, strict=True))


def _batch(cell: Cell) -> Dict[str, torch.Tensor]:
    """The step's batch on `meta`: int32 tokens [B, T] (decode: [B]) and,
    for a train or prefill cell of a frontend or enc-dec model, its bf16
    embeddings [B, frontend_len, d]."""
    cfg = cell.model.cfg
    meta = dict(device="meta")
    if cell.kind == "decode":
        return {"tokens": torch.empty((cell.batch,), dtype=torch.int32,
                                      **meta)}
    bs = {"tokens": torch.empty((cell.batch, cell.seq_len),
                                dtype=torch.int32, **meta)}
    emb = (cell.batch, cfg.frontend_len, cfg.d_model)
    if cfg.family == "encdec":
        bs["enc_embed"] = torch.empty(emb, dtype=torch.bfloat16, **meta)
    elif cfg.frontend != "none":
        bs[f"{cfg.frontend}_embed"] = torch.empty(emb, dtype=torch.bfloat16,
                                                  **meta)
    return bs


def _layout(cell: Cell, mesh):
    """The sharding rules of `cell` on `mesh`: an inference cell of an
    arch outside `_BIG` keeps its parameters off the fsdp axes, as the
    reference's does."""
    overrides = {}
    if cell.kind != "train" and cell.model.cfg.name not in _BIG:
        overrides["fsdp"] = ()          # inference: TP-only params
    return use_mesh(mesh_shape(mesh), **overrides)


def arg_bytes(cell: Cell, mesh) -> Dict[str, int]:
    """Per-device bytes of the cell's step arguments on `mesh` ({axis:
    size}), by tree: params, opt (train: AdamW's state and the step),
    state (decode) and batch (`_batch`, on the batch axis)."""
    model = cell.model
    sizes = mesh_shape(mesh)
    with _layout(cell, mesh):
        params = model.init(0)
        parts = {"params": tree_bytes_per_dev(params, params_pspecs(params),
                                              sizes)}
        if cell.kind == "train":
            state = TrainState(params, adamw.init(params, cell.opt_cfg),
                               torch.zeros((), dtype=torch.int32,
                                           device="meta"))
            parts["opt"] = tree_bytes_per_dev(
                state, params_pspecs(state), sizes) - parts["params"]
        if cell.kind == "decode":
            st = model.init_decode_state(cell.batch,
                                         cross_len=cell.cross_len)
            parts["state"] = tree_bytes_per_dev(st, decode_state_pspecs(st),
                                                sizes)
        batch = _batch(cell)
        specs = {k: logical_to_spec(("batch",) + (None,) * (v.dim() - 1),
                                    v.shape) for k, v in batch.items()}
        parts["batch"] = tree_bytes_per_dev(batch, specs, sizes)
    return parts


def step_read_bytes(cell: Cell, mesh, parts: Dict[str, int]
                    ) -> Dict[str, int]:
    """Per-device bytes one step of `cell` reads (`COST_MODEL`'s
    bytes_accessed), by tree: `parts`, the cell's argument bytes
    (`arg_bytes` or `probe_arg_bytes`), but for a decode cell under
    unicaim's top-k race the cache's K/V rows (K and V with a bf16 cache;
    V and its scales with an int8 one, whose K is the mirror) count
    select_k of each device's slots. Every other leaf of the state is read
    whole. The state is built at `cell`'s depth (cheap on `meta`)."""
    read = dict(parts)
    prune = cell.model.prune
    if (cell.kind != "decode" or prune.policy != "unicaim"
            or prune.select_mode != "topk"):
        return read
    sizes = mesh_shape(mesh)
    with _layout(cell, mesh):
        st = cell.model.init_decode_state(cell.batch)
        if st.kv is None:                       # no cache (SSM)
            return read
        specs = decode_state_pspecs(st).kv
    kv = st.kv
    rows = ("k", "v") if kv.kq is not None else ("v", "vscale")
    row_bytes = sum(tree_bytes_per_dev(getattr(kv, f), getattr(specs, f),
                                       sizes)
                    for f in rows if getattr(kv, f) is not None)
    read["state"] -= row_bytes * (kv.slots - prune.select_k) // kv.slots
    return read


def probe_arg_bytes(cfg, shape: ShapeConfig, mesh, policy="unicaim",
                    opts=(), prune=None) -> Dict[str, int]:
    """`arg_bytes` at `cfg`'s full depth, extrapolated from trees of 2
    layers a `cost_basis` dimension and of 3 along each in turn. Every
    probe keeps the full model's AdamW moments (int8 past 2e10
    parameters), which a shallow probe's own count would not choose."""
    make, full = cost_basis(cfg)
    base = {k: 2 for k in full}
    quantized = cfg.param_count() > 2e10

    def count(counts):
        return arg_bytes(build_cell(make(counts), shape, policy, opts,
                                    prune, quantized), mesh)

    at_base = count(base)
    per_dim = {}
    for dim in full:
        pt = dict(base)
        pt[dim] = 3
        at = count(pt)
        per_dim[dim] = {k: at[k] - at_base[k] for k in at_base}
    return {k: at_base[k] + sum((full[d] - base[d]) * per_dim[d][k]
                                for d in full) for k in at_base}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy: str = "unicaim", opts=()) -> dict:
    """One cell's record: the reference's fields, the analytic ones
    filled (`COST_MODEL`) and the compiler's None, with the roofline
    terms of `roofline.summarize`."""
    shape = SHAPES_BY_NAME[shape_name]
    cfg = get_config(arch)
    axes_shape, axes = production_mesh_shape(multi_pod)
    mesh = dict(zip(axes, axes_shape))
    t0 = time.time()
    parts = probe_arg_bytes(cfg, shape, mesh, policy, opts)
    read = step_read_bytes(build_cell(cfg, shape, policy, opts), mesh, parts)
    n_dev = 1
    for n in axes_shape:
        n_dev *= n
    mf = roofline.model_flops(cfg, shape)
    args_b = sum(parts.values())
    rec = {
        "arch": arch, "shape": shape_name, "policy": policy,
        "opts": list(opts),
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_dev,
        "kind": shape.kind,
        "flops": mf / n_dev,
        "bytes_accessed": float(sum(read.values())),
        "bytes_accessed_parts": read,
        "collective_bytes": None,
        "collectives": None,
        "arg_bytes_per_dev": args_b,
        "arg_bytes_parts": parts,
        "temp_bytes_per_dev": None,
        "peak_bytes_per_dev": None,
        "output_bytes_per_dev": None,
        "model_flops": mf,
        "param_count": int(cfg.param_count()),
        "active_param_count": int(cfg.active_param_count()),
        "useful_flops_ratio": None,
        "compile_s": None, "probe_s": None,
        "count_s": round(time.time() - t0, 3),
        "cost_source": "analytic", "cost_note": COST_MODEL,
        "notes": cell_notes(arch, shape),
    }
    rec.update({k: v for k, v in roofline.summarize(rec).items()
                if k not in rec})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--policy", default="unicaim")
    ap.add_argument("--opt", default="",
                    help="comma list of " + ",".join(COUNTED_OPTS)
                    + " (the reference's other variants change no "
                    "counted byte and are refused)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)
    try:
        check_opts(opts)
    except ValueError as e:
        ap.error(str(e))

    archs = ALL_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                if args.policy != "unicaim":
                    tag += f"_{args.policy}"
                for o in opts:
                    tag += f"_{o}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {tag}")
                    continue
                print(f"[run ] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, args.policy, opts)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[ ok ] {tag}: flops/dev={rec['flops']:.3e} "
                          f"bytes/dev={rec['bytes_accessed']:.3e} "
                          f"args={rec['arg_bytes_per_dev'] / 2**30:.2f}GiB "
                          f"dom={rec['dominant']} "
                          f"bound={rec['step_time_bound_s']:.3e}s "
                          f"count={rec['count_s']:.2f}s", flush=True)
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}")
                    traceback.print_exc()
    print(f"\n{len(failures)} failures")
    for tag, err in failures:
        print(" ", tag, err[:200])
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
