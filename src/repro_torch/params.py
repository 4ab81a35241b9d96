"""Weights from the reference: turn the tree of the reference's
`Model.init` into the port's parameters.

The tree comes as nested dicts (and lists) of numpy arrays
(`jax.tree.map(np.asarray, params)`) for any model the port builds, dense,
MoE, mla_moe, SSM, hybrid or enc-dec. The key names stay (`embed`,
`final_norm`, `lm_head`, `frontend_adapter`, and the segments
`seg0_dense`, `seg0_moe`, `seg0_ssm`, or `seg0_mla_dense` and
`seg1_mla_moe`, stacked on the layer
axis with `ln1`, `attn.{wq,wk,wv,wo}` and the optional `attn.{bq,bk,bv}` —
MLA's `attn.{wq_a,q_norm,wq_b,wkv_a,kv_norm,wkv_b,wo}` —, `ln2`, and
`mlp.{wi,wg,wo}` or `moe.{router,wi,wg,wo,shared}`; an SSD block's
`norm.w` and `ssm.{in_proj,conv_w,conv_b,A_log,D,dt_bias,norm_w,
out_proj}`; the hybrid's `ssm_groups` stacked [n_groups, attn_period,
...], `ssm_tail` [rem, ...] and one unstacked dense `shared_attn` block;
deepseek's `mtp` head with `proj`, `norm` and one unstacked `block`;
whisper's `seg0_encdec_enc` and `seg1_encdec_dec`, whose decoder blocks add
`ln_x` and the cross-attention `xattn.{wq,wk,wv,wo,bq,bk,bv}`), and
so does the layout: the reference's projections are [d_in, d_out] and the
port applies them as `x @ W` too.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.transformer import DTYPES

# leaves the reference keeps in f32 whatever the parameter dtype
# (`repro/models/moe.py`: the router; `repro/models/ssm.py`: A_log, D and
# dt_bias)
F32_LEAVES = ("router", "A_log", "D", "dt_bias")


def from_reference(tree: Any, dtype: str = "float32", device="cpu") -> Any:
    """Nested dicts and lists of numpy arrays → the same nesting of tensors
    in `dtype` on `device` (f32 for the leaves in `F32_LEAVES`)."""
    def convert(t, key):
        if isinstance(t, dict):
            return {k: convert(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [convert(v, key) for v in t]
        dt = torch.float32 if key in F32_LEAVES else DTYPES[dtype]
        arr = np.array(t, dtype=np.float32)             # a writable copy
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    return convert(tree, "")
