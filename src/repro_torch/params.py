"""Weights from the reference: turn the tree of the reference's
`Model.init` into the port's parameters.

The tree comes as nested dicts of numpy arrays (`jax.tree.map(np.asarray,
params)`); the key names stay (`embed`, `final_norm`, `lm_head`, and
`seg0_dense` stacked on the layer axis with `ln1`, `attn.{wq,wk,wv,wo}`,
`ln2` and `mlp.{wi,wg,wo}`), and so does the layout: the reference's
projections are [d_in, d_out] and the port applies them as `x @ W` too.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.transformer import DTYPES


def from_reference(tree: Dict[str, Any], dtype: str = "float32",
                   device="cpu") -> Dict[str, Any]:
    """Nested dict of numpy arrays → the same nesting of tensors in `dtype`
    on `device`."""
    dt = DTYPES[dtype]
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = from_reference(val, dtype, device)
        else:
            arr = np.array(val, dtype=np.float32)         # a writable copy
            out[key] = torch.from_numpy(arr).to(device=device, dtype=dt)
    return out
