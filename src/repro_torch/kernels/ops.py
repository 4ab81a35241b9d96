"""Dispatch to the Hopper kernels — the port of `repro/kernels/ops.py`.

A CUDA tensor on a card of compute capability >= 9.0 goes to the kernel, a
CPU tensor to the kernel's plain PyTorch version in `kernels/ref.py`, and
anything else raises. There is no fallback: a build or launch failure on
the card raises.
"""
from __future__ import annotations

from repro_torch.device import kernel_capable
from repro_torch.kernels import ref
from repro_torch.kernels.ragged_decode import ragged_decode


def fused_decode(q, qq, qscale, mirror, mscale, kscale, vscale, valid,
                 prot, k, v, select_k: int, num_blocks: int = 1, fills=None):
    """Fused single-pass pruned decode (score → select → gather → attend)
    → (out [BH, G, dv] f32, probs [BH, S] f32).

    With global selection (`num_blocks == 1`) and per-row live counts
    `fills` ([BH] int32) a card runs the ragged kernel, which skips the dead
    slot blocks of each row. Hierarchical selection (`num_blocks > 1`) has
    no port yet."""
    if num_blocks != 1:
        raise NotImplementedError(
            "fused decode with select_blocks > 1 (the reference's "
            "fused_decode kernel) is not ported yet")
    if q.device.type == "cpu":
        return ref.fused_decode_ref(q, qq, qscale, mirror, mscale, kscale,
                                    vscale, valid, prot, k, v,
                                    select_k=select_k)
    if not kernel_capable(q.device):
        raise RuntimeError(f"no ragged_decode kernel for {q.device}: the "
                           "port's kernels need compute capability >= 9.0")
    if fills is None:
        raise ValueError("the ragged kernel needs per-row fills")
    return ragged_decode(fills, q, qq, qscale, mirror, mscale, kscale,
                         vscale, valid, prot, k, v, select_k=select_k)
