"""Meshes — the port of `repro/launch/mesh.py`.

Two kinds, for the reference's two kinds of caller:

  * `LaneMesh` (`make_serve_mesh`): a single-controller 1-D ``data`` axis
    of `torch.device`s for `ServeLoop(mesh=...)`. Decode lanes are
    independent, so one process drives every shard and no process group
    is built. Shard i goes on ``cuda:(i mod device_count)``: on a one-card
    machine every shard shares ``cuda:0``.
  * DeviceMeshes over the current `torch.distributed` world
    (`make_host_mesh`, `make_elastic_mesh`, `make_production_mesh`), with
    the reference's axis names and shape logic, for the paths that run
    collectives (`runtime/sharding.use_mesh`).

Functions, never module-level constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class LaneMesh:
    """A 1-D ``data`` axis of devices: `shape` {"data": n}, `devices[i]`
    the device of shard i."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.shape: Dict[str, int] = {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"LaneMesh({[str(d) for d in self.devices]})"


def make_serve_mesh(n_shards: Optional[int] = None,
                    device="cuda") -> LaneMesh:
    """1-D lane-parallel serving mesh of `n_shards` shards (default: one
    a card). On the card, shard i lives on ``cuda:(i mod device_count)``;
    on the CPU every shard is the CPU."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        n = n_shards or count
        return LaneMesh([torch.device("cuda", i % count) for i in range(n)])
    return LaneMesh([dev] * (n_shards or 1))


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def production_mesh_shape(multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """16×16 single pod (256 ranks) or 2×16×16 multi-pod (512 ranks)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """A DeviceMesh of `production_mesh_shape` over the current world
    (which must hold 256 or 512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_mesh_shape(multi_pod)
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_host_mesh(device_type=None):
    """(1, world) over ("data", "model"): every rank of the current world
    on the model axis (tests / smoke runs)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(),
                            (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


def elastic_mesh_shape(n: int) -> Tuple[int, int]:
    """(data, model) for n ranks: the largest model axis of 16, 8, 4, 2, 1
    that divides n."""
    model = next(c for c in (16, 8, 4, 2, 1) if n % c == 0)
    return n // model, model


def make_elastic_mesh(n_devices: Optional[int] = None, device_type=None):
    """Rebuild a (data, model) DeviceMesh for the CURRENT world size — the
    elastic-scaling entry point after a topology change."""
    from torch.distributed.device_mesh import init_device_mesh
    n = n_devices or dist.get_world_size()
    return init_device_mesh(device_type or _device_type(),
                            elastic_mesh_shape(n),
                            mesh_dim_names=("data", "model"))
