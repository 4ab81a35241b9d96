"""Roofline terms for one NVIDIA H100 — the port of
`repro/launch/roofline.py`.

Terms (per device):
    compute    = flops / PEAK_FLOPS                      (bf16, dense)
    memory     = bytes_accessed / HBM_BW                 (HBM3)
    collective = collective_bytes / NVLINK_BW_PER_DIRECTION

The card is the H100 SXM 80 GB (HBM3, 700 W), at the datasheet's dense
peak rates. A card set below 700 W runs slower under load, so a share of
these bounds is stated beside the card's power limit.

The reference reads flops and bytes from XLA's `cost_analysis()` of the
compiled per-device program, and its collective bytes from the compiled
HLO text (`parse_collective_bytes`). Eager PyTorch compiles no program
and has no HLO text to parse, so that parse has no counterpart here: the
dry run (`launch/dryrun.py`) fills the terms from an analytic model, and
a record without collective bytes (None) has no collective term.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 dense tensor-core flop/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW_PER_DIRECTION = 450e9   # NVLink 4, bytes/s each way per card
PEAK_INT8_OPS = 1979e12    # int8 dense tensor-core op/s
PEAK_F32_FLOPS = 67e12     # f32 flop/s outside the tensor cores


def bound(nbytes, int8_ops=0.0, f32_flops=0.0, bf16_flops=0.0):
    """(bound_ms, bound_by) of one call: the larger of the bytes over the
    memory rate and the operations over their peak rates."""
    t_bytes = nbytes / HBM_BW
    t_ops = (int8_ops / PEAK_INT8_OPS + f32_flops / PEAK_F32_FLOPS
             + bf16_flops / PEAK_FLOPS)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: Optional[float]) -> Dict[str, float]:
    """The three terms in seconds, the dominant one and the compute term's
    share of the bound. `collective_bytes` None: that term is absent
    (`collective_s` None), not zero bytes."""
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_accessed / HBM_BW,
        "collective_s": (None if collective_bytes is None
                         else collective_bytes / NVLINK_BW_PER_DIRECTION),
    }
    present = [k for k in ("compute_s", "memory_s", "collective_s")
               if terms[k] is not None]
    dominant = max(present, key=lambda k: terms[k])
    terms["dominant"] = dominant
    bound_s = terms[dominant]
    terms["roofline_fraction_compute"] = (
        terms["compute_s"] / bound_s if bound_s > 0 else 0.0)
    return terms


def model_flops(cfg, shape, n_layers_active: int = None) -> float:
    """Analytic MODEL_FLOPS = 6·N·D (train) / 2·N·D (fwd) per step, using
    ACTIVE params for MoE. D = tokens processed this step (global)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention reads the cache but
    # the matmul-FLOPs term is 2·N per token
    return 2.0 * n_active * shape.global_batch


def summarize(cell: dict) -> dict:
    """cell: raw dryrun record → roofline row (a field the record already
    holds keeps its value when the caller merges the row in)."""
    terms = roofline_terms(cell["flops"], cell["bytes_accessed"],
                           cell["collective_bytes"])
    n_chips = cell["n_devices"]
    mf = cell.get("model_flops", 0.0)
    hlo_total = cell["flops"] * n_chips
    row = dict(cell)
    row.update(terms)
    row["useful_flops_ratio"] = (mf / hlo_total) if hlo_total else 0.0
    row["step_time_bound_s"] = terms[terms["dominant"]]
    row["mfu_bound"] = (mf / n_chips / PEAK_FLOPS) / row["step_time_bound_s"] \
        if row["step_time_bound_s"] > 0 else 0.0
    return row
