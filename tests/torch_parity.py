"""Shared helpers for the port's parity tests: build the reference model
and the port's model from one config and one seed, with the same weights,
and move arrays between the two (numpy in between)."""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import baselines as jax_baselines
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import baselines
from repro_torch.models.transformer import Model
from repro_torch.params import from_reference


def prune_pair(policy: str = "unicaim", **kw):
    """The same PruneConfig on both sides, from the baselines of each."""
    return (getattr(jax_baselines, policy)(**kw),
            getattr(baselines, policy)(**kw))


def model_pair(arch: str, policy: str = "unicaim", seed: int = 0, **kw):
    """(jax model, jax params, port model, port params) for the reduced
    `arch` (f32), the port's weights converted from the reference's."""
    jprune, tprune = prune_pair(policy, **kw)
    jm = JaxModel(jax_reduced(jax_get_config(arch)), jprune)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = Model(reduced(get_config(arch)), tprune, device="cpu")
    tp = from_reference(jax.tree.map(np.asarray, jp), "float32", "cpu")
    return jm, jp, tm, tp


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
