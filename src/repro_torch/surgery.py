"""Cache & decode-state surgery — the single public namespace. The port of
`repro/surgery.py`.

Per-field `KVCache` surgery lives in `repro_torch.core.cache` and the
DecodeState-level wrappers in `repro_torch.models.transformer`. This module
is the one documented place to import them from; the serving engine's
admission and prefix-copy paths (`launch/serve.py`,
`launch/prefix_cache.py`) use these names.

Naming convention — the prefix says what a helper operates on:

``state_*`` — whole `DecodeState`s (batch axis 1, layer-stacked):
  state_lane_slice(state, lane)            one lane as a batch-1 state
  state_lane_insert(state, lane, fresh)    splice a batch-1 state in
  state_lanes_insert(state, src, fresh)    multi-lane splice
  state_lane_select(active, new, old)      per-lane merge

``kv_*`` — bare `KVCache` instances (batch_axis selects layout):
  kv_lane_slice / kv_lane_insert / kv_lanes_insert / kv_lane_reset

Prefix snapshots (prefix-sharing admission):
  prefix_slot_aligned(kv, length)          identity-layout check
  cache_prefix_rows(kv, length)            host rows [0, length) or None

Not here, by design:
  slot_window, slot_window_merge, decode_window — the port has no decode
      window: eager decode writes in place and the decode kernels skip
      each lane's dead slot blocks themselves;
  lane_shardings — a lane-sharded `ServeLoop` keeps one state a shard on
      that shard's device (`launch/mesh.LaneMesh`), so there is no
      sharding object to build; `lane_pspecs` (below) names the layout.

Lane sharding:
  lane_pspecs(tree, mesh)                  lane-axis specs over "data"

The inserts copy every cache field in place — the int8/quantized mirrors,
their scales and the accumulated eviction scores included — and the SSM
state and an enc-dec model's cross K/V with them (batch axis 1 too), so
per-lane state stays exact across surgery; the slices and snapshots are
copies, so later writes to the live state never reach them.
"""
from __future__ import annotations

from repro_torch.core.cache import (cache_prefix_rows,
                                    lane_insert as kv_lane_insert,
                                    lane_reset as kv_lane_reset,
                                    lane_slice as kv_lane_slice,
                                    lanes_insert as kv_lanes_insert,
                                    prefix_slot_aligned)
from repro_torch.runtime.sharding import lane_pspecs
from repro_torch.models.transformer import (lane_insert as state_lane_insert,
                                            lane_select as state_lane_select,
                                            lane_slice as state_lane_slice,
                                            lanes_insert as state_lanes_insert)

__all__ = [
    "state_lane_slice", "state_lane_insert", "state_lanes_insert",
    "state_lane_select",
    "kv_lane_slice", "kv_lane_insert", "kv_lanes_insert", "kv_lane_reset",
    "prefix_slot_aligned", "cache_prefix_rows", "lane_pspecs",
]
