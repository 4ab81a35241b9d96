#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order (no failure is caught: any one exits non-zero):
  1. device  — a CUDA card of compute capability >= 9.0, its name and
               power limit (nvidia-smi);
  2. build   — every kernel of the port, built from the sources in this
               checkout (nvcc, one process per source) unless the build
               cache holds them; the registers, stack and local memory
               (spills) of the prompt kernel's routes and the HMMA and
               HGMMA (tensor-core, warpgroup) instructions in their SASS
               (cuobjdump; the latent route must hold HGMMA and spill
               nothing); the registers, stack and local memory of every
               approx_score and gather_attention instantiation (any spill
               fails, and the served ones must be there);
  3. kernels — each kernel against its plain PyTorch version on the card,
               at longchat-7b, granite-like (GQA), starcoder2-3b (G = 12),
               grok-1-314b (G = 6, ragged_decode), zamba2-7b (d = 112) and
               whisper-base (d = 64, G = 1) decode shapes, bf16 and int8
               K/V (the decode kernels' G = 12, d = 112 and d = 64 times
               with L2 cold beside the served shape's), flash_prefill with
               group 12, at d = 112 and at d = 64 (timed at zamba2-7b's and
               whisper-base's 4 x 2048 prompt shapes),
               and flash_prefill at the served prompt shape
               (4 x 2048, both contracts, lengths, obs_window, a row0
               chunk, chunked-vs-whole column sums bit for bit; bf16 on
               the tensor cores, its division checked bit for bit against
               the operator, its out error over 12 seeds with and without
               its exact rows beside the f32 route's; f32 on the CUDA
               cores), flash_prefill's latent route at MLA's shape (128
               q-heads over one latent, d = 576, dv = 512, V a view,
               B = 2, N = 2048, lengths 2048 and 1377, obs_window 0 and
               32; timed there and at 4 x 2048, with and without its
               exact rows, beside the count of exact rows), with CUDA-event
               times beside the reckoned bound (and beside the one PyTorch
               call that computes the function, where there is one);
               approx_score (both routes, bit for bit) and gather_attention
               (GATHER_ATOL) also at the edges of their tilings (S and K
               no multiple of a tile, empty tiles and rows, one valid
               slot, G = 16, d = 40 to 4096, rows past gather's shared
               memory stage, misaligned rows, the largest K the wrapper
               admits at G = 1 and 16 and the refusal of one more), two
               launches of each bit-equal, and both timed at the
               longchat-7b, granite-like and starcoder2-3b shapes with
               inputs in L2 and with L2 cold;
  3b. long  — both decode kernels' long route (the one that takes any S;
               the single-CTA route's shared memory caps it near 22,640
               slots at G = 1) against their plain versions at the long
               shapes: longchat-7b decode_32k (32 rows, G 1, d 128, S
               32,768, select_k 2,048), granite-3-2b decode_32k (8 rows, G
               4, d 64), starcoder2-3b at S 32,768 (G 12) and granite-3-2b
               long_500k (S 524,288), bf16 and int8 K/V, rows full,
               ragged, free and below select_k, ragged_decode and
               fused_decode with 4 selection blocks, random inputs and
               slot-bit inputs whose out counts the winners' slot bits
               (winner sets the plain race's exactly), two launches
               bit-equal, each counted under its route's key alone; then
               their times with L2 cold beside the plain version and the
               bound;
  3c. shard — the decode kernels' sharded route on one rank's block (the
               global race and one block a rank) at [slots]' and [mesh]'s
               block shapes: the stage kernels' CUDA-event time (the
               collectives not in it), the plain stages' and the bound of
               the block's bytes;
  4. serve   — full-width longchat-7b (random bf16 weights from a seed)
               serving 8 requests on 4 lanes through `ServeLoop`, bf16 and
               int8 KV, first with global selection (the ragged_decode
               kernel), then with select_blocks = 4 (the fused_decode
               kernel); with bf16 KV and global selection, from one
               prefilled state the kernel's path and the composed plain
               decode path teacher-forced with the same tokens (the logit
               difference a step, the top-1 agreement held to a floor, the
               top-2 gap where it differs); each path's decode kernel
               must launch 32 x its decode steps and the other never, and the
               prompt pass flash_prefill 32 x its prefill dispatches with
               no plain prompt attention on the card; then the same
               requests with chunked admission (chunk_prefill = 512), held
               to the whole-admission run;
  5. paths   — one decode step from one prefilled state, fused kernel vs
               the composed plain path, layer-0 attention outputs and
               accumulated scores compared; with global selection also the
               three-pass step through the ops kernels (approx_score, int4
               approx_score_packed, top-k, gather_attention); then a few
               decode steps under torch.profiler: host wall per step
               against the device time of its kernels; and one 4 x 2048
               prompt pass under torch.profiler;
  5b. dryrun — the tooling layer on phase 4's weights (about 5 s): the
               dry run's shape-only count (`launch/dryrun.py`, 2- and
               3-layer probes on `meta`, a one-card mesh) of longchat-7b's
               parameters and of a fresh 4-lane decode state, bf16 and int8
               KV, equal byte for byte to the trees on the card, and the
               allocator's growth while the state is made within 1% of
               it; phase 4's decode steps and prompt pass (host wall and
               kernel time) beside `roofline.summarize`'s bound for the
               same work (model flops; the bytes read: the arguments
               once, but of the cache's K/V rows only the select_k
               winners'), a share above 1.05 failing; `dryrun.main` for longchat-7b x
               decode_32k on the 16 x 16 mesh and `report.main` over its
               record; the H100 constants beside the card's power limit;
  6. prefix  — the prefix cache: 8 requests sharing a 1,536-token system
               prompt (two exact repeats, one sharing 1,024 tokens, one
               unrelated) through one ServeLoop configuration
               (chunk_prefill = 512, global selection), bf16 and int8 KV
               (bf16 with half the new tokens, int8 with a quarter), cold
               (no cache)
               and warm (a budget that holds every entry):
               warm streams equal cold ones exactly, the hit, exact-hit and
               chunk counts are the trace's, flash_prefill launches 32 x
               the chunk dispatches and ragged_decode 32 x the decode steps
               in both loops, and the trie's counted bytes lie in (0,
               budget]; printed: wall, tok/s, TTFT, and the host time of
               the snapshot copies and of an exact-hit splice;
  7. perlane — per-lane sampling knobs, a preemption and reservation: 6
               requests of about 1,024 tokens on 4 lanes (global
               selection, block 8), bf16 and int8 KV: two greedy, a top-k
               and a top-p request with pinned seeds, one greedy with its
               own stop token, and after one block a priority-1 arrival
               that must preempt. Held: the greedy streams equal an
               all-greedy twin loop's, the stop token stops its lane (its
               stream is a probe run's up to the token's first
               occurrence), each sampled stream equals the one from the
               trace submitted in reverse order (another lane, no
               preemption) — the preempted victim's too — and
               ragged_decode launches 32 x the decode steps; an all-greedy
               block dispatches exactly the ops (so the launches) of the
               block with one stop token that the engine ran before
               per-lane knobs, a sampled block synchronises the host nowhere
               an all-greedy one does not, and 512 sampler draws at [4,
               32000] stay inside their truncated support; printed: the
               sampler's device time per step, device events and card
               time a step, host wall per step with and without sampled
               lanes, and the bytes and seconds of a preemption's capture
               and resume;
  8. faults  — fault tolerance on the same weights and pruning, 4 lanes,
               block 8, 6 requests of about 1,024 tokens (greedy, top-k
               and top-p with seeds): a clean loop and one whose lanes 0
               and 1 take NaN logits in block 1 (bf16 and int8 KV: the
               two requests are quarantined, prefilled again and their
               streams equal the clean loop's), then (bf16) an inert
               ChaosConfig, exhausted retries (the failed request keeps the
               clean stream's prefix), a deadline that passes inside a
               stall (the lane frees within one block), cancellation of an
               active and a queued request, a flood against max_queue
               (rejections with retry_after) and the degrade ladder
               (streams unchanged); on every loop ragged_decode launches 32
               x the decode steps and flash_prefill 32 x the prefill
               dispatches (re-prefills included); a block with a fault
               mask synchronises the host nowhere a clean one does not.
               Printed: each loop's wall and counters, the wall a
               quarantine and retry add, the card ms and device events of
               the sentinel and the mask, blocks and ms from a deadline's
               expiry to its free lane, and retry_after.
  8b. sharded — the lane-sharded ServeLoop on phase 4's weights (full
               width and depth): phase 4's 8 requests through
               ServeLoop(mesh=2), 2 shards x 2 lanes on max(1, cards)
               cards, bf16 KV with select_blocks 1 (ragged_decode) and
               int8 KV with select_blocks 4 (fused_decode): the decode
               kernel launches cache layers x shards a step, flash_prefill
               cache layers a prompt pass, nothing else; the per-shard
               token counters sum to the total; the streams are compared
               with phase 4's one-shard run of the same configuration,
               and where they part the first step is printed, each shard's
               requests through a one-shard loop of 2 lanes must stream
               as that shard did, and 4-lane and 2-lane batches fed the
               same tokens must agree on top-1 in TEACHER_AGREE_MIN of 64
               steps. Printed: tok/s, p50 TTFT, each shard's tokens and
               tok/s, launches a step.
  8d. long  — long-context decode on the long route: phase 4's
               longchat-7b at decode_32k's pruning (the reference dry
               run's: heavy 32,704, reserve 64, select_k 2,048) serving
               prompts of 32,000 and 24,576 tokens on 2 lanes through
               ServeLoop (chunk_prefill 4,096, int8 K/V: bf16 chunked
               admission does not fit beside 2 bf16 lanes on 80 GB), 16
               new tokens each, 32 ragged_decode_long launches a step and
               no other decode kernel; the 32,000-token prompt on 1 lane,
               bf16, teacher-forced kernel path vs composed path for 16
               steps (top-1 at TEACHER_AGREE_MIN of 64); then, after the
               weights are freed, granite-3-2b at full width and depth at
               long_500k (524,288 slots, int8 K/V, one lane, ~24 GB), its
               caches filled through `prefill_fill` from seeded K/V rows,
               4 decode steps (40 ragged_decode_long launches each) and 2
               with 4 selection blocks (fused_decode_long), layer 0's next
               step against the plain version, gather_attention over the
               same winners and the composed path; the same 4 steps on
               a fresh state computed as 8e's ranks compute them
               (`laid_out_on_one_card`: the head blocks' projections, the
               sharded route over the slot blocks), saved for 8e with the
               whole state's steps; printed: tok/s, p50
               TTFT, a long_500k step's wall and kernel time (long_500k
               and 8e run right after phase 3, while this process holds
               nothing on the card);
  8e. slots — granite-3-2b at long_500k laid out over a world of 4
               spawned ranks (data 2 x model 2, the reference's
               `decode_state_pspecs`: 4 of 8 kv-heads and 262,144 of
               524,288 slots a rank; NCCL with a card each, else gloo on
               this card), each rank's blocks filled from 8d's seeded rows
               of its heads, 8d's 4 decode steps through
               `Model.decode_step` on the decode kernels' sharded route
               (ragged_decode_shard, 40 a step a rank): logits within
               SLOTS_LAID_ATOL of 8d's steps computed on one card as the
               ranks compute them and within SLOTS_LOGIT_ATOL of its
               whole state's steps (fixed limits: `slots_witness` reads
               what faults give), greedy argmax equal to both but at a
               printed near-tie; layer 0's next step
               against the unsharded long route over the gathered slots
               (winner sets equal, out within OUT_ATOL, probs at scale);
               printed: launches by route, each rank's peak memory, a
               step's wall and kernel time;
  8c. mesh  — the collective paths in 8e's world of 4 spawned ranks
               (NCCL with a card each, else gloo, every rank on this
               card), once each rank has freed 8e's state: the slot-sharded
               decode at longchat-7b's full-width layer (4 lanes x 32
               kv-heads, d 128, S 1088 = 4 x 272 slots, select_k 128),
               bf16 and int8 KV, one block a rank and the global race,
               MESH_STEPS steps from a prefilled cache (the last 16
               evicting) on the decode kernels' sharded route (the fused
               engine; no plain attention in its steps), against the
               unsharded kernels on the whole cache and the sharded plain
               path;
               deepseek-v3's latent race at full width (128 heads, latent
               576, S 1088, full budget) against dense latent attention;
               grok-1-314b's MoE layer with moe_ep (8 experts of 6144 x
               32768 over the 4 ranks, f32 weights, 4 x 64 tokens)
               against apply_moe; each within MESH_ATOL. Printed: the
               backend, which collectives it took on CUDA tensors, where
               each collective's operands lived, every worst error.
  9. family  — the rest of the dense family and the MoE family at full
               width, random bf16 weights from the seed, each model freed
               before the next: starcoder2-3b (LayerNorm, tanh-GELU, qkv
               bias, G = 12; 30 layers) served as in phase 4 (bf16 and
               int8 KV, select_blocks 1 and 4; bf16 with select_blocks 4
               and int8 with 1 cut to 4 requests of 16 new tokens;
               teacher-forced kernel vs composed path, chunk_prefill = 512
               on 4 requests of 16 new tokens held to whole admission),
               minitron-8b (LayerNorm, relu², vocab 256,000;
               32 layers) and phi3-medium-14b (40 layers, 4 requests of 16
               new tokens) served once, llava-next-mistral-7b (the vision
               frontend; 32 layers) through greedy_generate behind a seeded
               [4, 576, 4096] vision_embed (cache.step = 576 + length), and
               grok-1-314b (MoE: 8 experts of d_ff 32,768) with its depth
               cut to 4 layers, served bf16 and int8 and with
               chunk_prefill = 512, printing the (token, choice) pairs each
               prompt pass drops to the experts' capacity. Every serve's
               launch counts and its no-plain-prompt-attention check hold;
               printed: wall, tok/s, TTFT, peak memory.
 10. mla     — deepseek-v3-671b (MLA latent attention, 256 experts and a
               shared one, dense first 3 blocks, the MTP head) at full
               width, its depth cut to 5 layers, random bf16 weights from
               the seed, after phase 9's models are freed: phase 4's 8
               requests on 4 lanes, bf16 (global selection, select_blocks
               4, the threshold race, chunk_prefill 512) and int8 (global
               selection, select_blocks 4) latent KV; every serve's
               streams equal its dtype's first run's (the reference's
               latent attend ignores those knobs without a mesh; an MLA
               model admits whole prompts), flash_prefill's latent route
               launches 5 x prefill dispatches, no decode kernel and no
               plain prompt attention runs on the card; the prompt pass
               through the kernel and through its plain version keep the
               same positions in every layer (at least 99%), and with the
               dense policy agree on top-1 at least 55 of 64 times over
               16 teacher-forced steps (under the served pruning that
               agreement is printed). Printed: wall, tok/s, TTFT, the
               MoE's drops, a decode step's wall, a profiled 4 x 2048
               prompt pass, peak memory, the exact rows of every layer's
               absorbed q and latent and the latent route's time on layer
               0's (as served, without exact rows, the plain version).

 11. ssm     — Mamba2 SSD blocks at full width and depth, random bf16
               weights from the seed, after phase 10's model is freed:
               mamba2-1.3b (48 blocks, no KV cache) serves phase 4's 8
               requests on 4 lanes (exact-length whole prompts) under the
               dense policy twice: equal greedy streams, no kernel launch
               and no plain prompt attention on the card; a 4 x 2048
               prompt pass and the decode of token 2048 against the prompt
               pass over 2049 tokens (logits within CONT_ATOL, the same
               top-1). Then zamba2-7b (81 SSD blocks and 13 applications
               of one shared attention block, 32 heads of d = 112) under
               unicaim(heavy=1024, reserve=64, select_k=128), bf16 and int8
               KV, select_blocks 1 and 4 (4 requests of 16 new tokens
               each): 13 ragged_decode / fused_decode
               launches a decode step, 13 flash_prefill launches a prompt
               pass, nothing else; the prompt pass through flash_prefill
               and through its plain version keep the same positions in
               each of the 13 caches (at least 99%, bf16 and int8; their
               teacher-forced top-1 agreement over 16 steps is printed).
               For
               each model: a decode step and a 4 x 2048 prompt pass
               profiled (the SSD blocks' share by CUDA events,
               flash_prefill's by the profiler), the prefix cache's
               exact-hit splice of a repeated prompt (its wall and bytes,
               SSM state apart), peak memory.
 12. encdec  — whisper-base (the enc-dec family: 6 encoder blocks of
               bidirectional attention over a seeded [4, 1500, 512]
               enc_embed, 6 decoder blocks of pruned self-attention, cross-
               attention and MLP; 8 heads of d = 64, vocab 51,865) at full
               width and depth, random bf16 weights from the seed, after
               phase 11's models are freed, through the CLI's path
               (`Model.prefill`, then 32 greedy tokens through
               `decode_block`; `ServeLoop` admits token prompts only) under
               unicaim(heavy=1024, reserve=64, select_k=128), bf16 and int8
               KV, select_blocks 1 and 4, four equal prompts of 2,048 tokens
               (the static top-k prunes) and of 448 (whisper's own decoder
               context: the cache keeps every row). Held: flash_prefill
               launches 6 times a prompt pass and no decode kernel,
               ragged_decode / fused_decode 6 times a decode step and the
               other never, no plain prompt attention on the card, every
               lane's cache step equals its prompt length after the
               prefill; at 2,048 tokens the prompt pass through
               flash_prefill and through its plain version keep at least
               KEPT_MIN of each of the 6 caches' positions (bf16 and int8;
               at 448 both keep every row, so it is not checked there); the
               decode kernel's path and the composed one, teacher-forced
               from the 2,048-token state, agree on top-1 at least
               TEACHER_AGREE_MIN of 64 times (from the 448-token states,
               printed only). Printed: wall, tok/s, TTFT,
               the cross K/V's bytes, a 4 x 2048 prompt pass profiled (the
               encoder's share by CUDA events around `Model._encode`,
               flash_prefill's by the profiler), a decode step's wall,
               kernel time and launches, peak memory.
 13. train   — training, after phase 12's model is freed: the attention
               backward kernel (flash_prefill_bwd) against its plain
               version at the five shapes the training path gives it (4 x
               2048 rows; granite-3-2b d 64 G 4, longchat-7b d 128,
               starcoder2-3b d 128 G 12, zamba2-7b's shared block d 112,
               whisper-base d 64; bf16 with a bf16 dout, the model's
               cotangent, and with an f32 one, split into bf16 hi and lo;
               f32 at a reduced shape): each
               gradient element within one bf16 ulp of itself plus one of
               its row's largest (f32: 1e-5), two
               launches bit-equal, CUDA-event times of both cotangents
               beside the bound, the plain version and SDPA's backward;
               the registers, spills and HGMMA count of every backward
               kernel instantiation (cuobjdump: each bf16 one must hold
               HGMMA and spill nothing); then granite-3-2b at full
               width and depth (random bf16 weights from the seed) through
               `launch/train.py`'s functions at the CLI's settings (--batch
               8 --seq 256 --lr 1e-3) with int8 moments, 10 steps straight
               and 10 through `fault.run_training` (a checkpoint every 8
               steps, a RuntimeError before step 9): held, restarts 1, the
               final opt.step, the resumed losses bit-equal to the
               straight run's, flash_prefill and flash_prefill_bwd 40
               launches a forward and a backward pass, no plain attention
               on the card; granite-3-2b cut to REMAT_LAYERS layers: the
               gradients under remat 'nothing' and 'dots' bit-equal to
               those without remat (flash_prefill 2 x layers under
               remat); one step at 4 x 2048 tokens (f32 moments,
               remat: flash_prefill 2 x 40, flash_prefill_bwd 40) with its
               wall, tokens/s, peak memory and the backward kernel's share
               of its kernel time (torch.profiler); whisper-base at full
               width and depth for 3 steps (448 decoder tokens behind a
               seeded [4, 1500, 512] enc_embed; 6 launches of each a step).
 14. mla-train — MLA training, after phase 13's models are freed: the
               backward's latent route (128 q-heads over one latent, d =
               576, dv = 512, V a view; B 2 and 4 x 2048, an f32 and a
               bf16 dout) against its plain version: dq within phase 13's
               limit plus one dP rounding flip of its row, the latent's
               gradient du within that limit of the plain dk + [dv, 0];
               two launches bit-equal; its f32 dout split bit-equal to
               the plain split; CUDA-event times beside the bound, the
               plain version and SDPA's backward (the time by kernel is
               `latent_bwd_times()`, a command of its own); then
               deepseek-v3-671b at full width cut to its 3 mla_dense
               blocks and the MTP head, 5 steps at 8 x 256 with
               int8 moments (4 flash_prefill and 4 flash_prefill_bwd
               launches a step, finite loss and mtp_loss), layer 0's own
               inputs beside the plain version (printed), and one 2 x
               2048 step under remat, profiled.

Every launch count is reset just before the path it counts and read just
after. The second-to-last line is a JSON object describing every kernel;
the last is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import gc
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.base import (SHAPES_BY_NAME,  # noqa: E402
                                      ShapeConfig, get_config)
from repro_torch.core import baselines, quant, scoring, topk  # noqa: E402
from repro_torch.core.attention import (decode_attention,  # noqa: E402
                                        shard_cache, shard_rows, slot_layout)
from repro_torch.core.cache import (FIELDS, init_cache,  # noqa: E402
                                    prefill_fill, protected_mask,
                                    write_token)
from repro_torch.kernels import approx_score as approx_mod  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import SyntheticSource  # noqa: E402
from repro_torch.kernels import flash_prefill as flash_mod  # noqa: E402
from repro_torch.kernels import flash_prefill_bwd as bwd_mod  # noqa: E402
from repro_torch.kernels import fused_decode as fused_mod  # noqa: E402
from repro_torch.kernels import gather_attention as gather_mod  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import ragged_decode as ragged_mod  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.launch.roofline import bound  # noqa: E402
from repro_torch.launch.serve import (Request, SamplingParams,  # noqa: E402
                                      ServeLoop, _next_token_lanes,
                                      bucket_length, decode_block,
                                      decode_block_lanes,
                                      greedy_generate, gumbel_noise)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import attention_layer as layer_mod  # noqa: E402
from repro_torch.models.attention_layer import decode_qkv  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.prefix_cache import _tree_nbytes  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.mla import _mla_blocked_shardmap  # noqa: E402
from repro_torch.models.transformer import (Model,  # noqa: E402
                                            _store_layer, layer_params)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.runtime.chaos import ChaosConfig, flood  # noqa: E402
from repro_torch.runtime.sharding import (ProcessMesh,  # noqa: E402
                                          all_gather, use_mesh)
from repro_torch.tree import leaves, tree_map  # noqa: E402
from repro_torch.surgery import (state_lane_insert,  # noqa: E402
                                 state_lane_slice)

OUT_ATOL, PROBS_ATOL = 1e-3, 1e-5  # f32 on both sides, other sum order
# probs at a long S, at its own scale: a row's probs average G / live
# (7.6e-6 at long_500k's G = 4), below PROBS_ATOL, so each slot is held
# within PROBS_RTOL of |p| plus that share, and each row's sum to G
PROBS_RTOL, PROBS_SUM_RTOL = 1e-4, 1e-5
GATHER_ATOL = 1e-4                 # f32 on both sides, other sum order
PATH_ATOL = 1e-2                   # bf16 activations
# flash_prefill: f32 probabilities, other sum order
FLASH_OUT_ATOL, FLASH_ACC_RTOL = 1e-3, 1e-4
# probabilities rounded to bf16 on both sides (the model's contract): one
# that lies within sum-order noise of a bf16 rounding boundary rounds the
# other way, by one bf16 ulp (at most 2^-7 of it), and so does its share of
# a column sum; the count of sums past FLASH_ACC_RTOL is printed
FLIP_ACC_RTOL = 2.0 ** -7
KEPT_MIN = 0.99                    # chunked vs whole: kept slots agreeing
# teacher-forced top-1 agreement of the kernel's and the composed decode
# path over 16 steps x 4 lanes: with random weights the two summation
# orders settle near-ties (top-2 gaps below 0.08) either way; the served
# weights and prompts agree in 59 of 64 on an H100, and the floor leaves
# four more near-ties room
TEACHER_AGREE_MIN = 55
COUNTERS = (ragged_mod.LAUNCHES, fused_mod.LAUNCHES, approx_mod.LAUNCHES,
            gather_mod.LAUNCHES, flash_mod.LAUNCHES, bwd_mod.LAUNCHES)
SEED = 0
# the CLI's --prompt-len 2048 --new-tokens 32 --serve workload
PROMPT_LEN, NEW_TOKENS, LANES = 2048, 32, 4
CHUNK = 512                        # chunked admission's slice
LENS = (PROMPT_LEN, PROMPT_LEN // 2, PROMPT_LEN - 7, PROMPT_LEN // 3)
SERVED_SEED = len("served")        # the served prompt check's inputs


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def reset_launches():
    for c in COUNTERS:
        for name in c:
            c[name] = 0


def launch_counts():
    return {name: n for c in COUNTERS for name, n in c.items()}


SLEEP_CYCLES_PER_S = 2.0e9        # above the H100's SM clock: sleeps run long


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The card's time per call, CUDA events around `iters` calls queued
    behind a sleep kernel that outlasts their host time, so a call whose
    wrapper takes longer on the host than its kernels on the card is
    timed by its kernels, back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    host_s = time.monotonic() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * (iters + 2) * host_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def long_ms(fn, iters: int = 3) -> float:
    """The card's time per call of a function whose kernels run far longer
    than its host time: CUDA events around `iters` calls after a warm one
    (no sleep needed to queue them)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, inputs, iters: int = 20) -> float:
    """`cuda_ms` of fn(*inputs[i]) over input sets taken in turn: with
    enough sets the 50 MB L2 holds none of a call's inputs when it starts,
    as in a served decode step, where the other layers run in between."""
    turns = itertools.cycle(inputs)
    return cuda_ms(lambda: fn(*next(turns)), iters)


COLD_SETS = 4                      # x ~90 MB of decode inputs: L2 is 50 MB


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall time per call on the host, each call waited for: its wrapper's
    host time plus its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.monotonic() - t0) / iters * 1e3


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of the prompt kernel
# ---------------------------------------------------------------------------

# the served instantiations: head dim 128, bf16-rounded (model contract)
# and f32 (TPU contract) probabilities; zamba2-7b's shared block at 112;
# whisper-base's decoder at 64
SERVED_TC = ("flash_prefill_tc_kernel<128, true>",
             "flash_prefill_tc_kernel<128, false>",
             "flash_prefill_tc_kernel<112, true>",
             "flash_prefill_tc_kernel<64, true>")


LATENT_TC = "flash_prefill_latent_kernel"


def prompt_kernel_name(text):
    """The demangled name of a prompt kernel in a mangled one, or None."""
    m = re.search(r"flash_prefill_tc_kernelILi(\d+)ELb([01])E", text)
    if m:
        return (f"flash_prefill_tc_kernel<{m.group(1)}, "
                f"{'true' if m.group(2) == '1' else 'false'}>")
    if "flash_prefill_latent_kernel" in text:
        return LATENT_TC
    return "flash_prefill_f32_kernel" if "flash_prefill_f32_kernel" in text \
        else None


def cuobjdump():
    """The toolkit's cuobjdump, or None (then nothing is measured)."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    return tool if tool.exists() else None


def res_usage(tool, kernel, namer):
    """{name: registers, stack and local bytes} of every function of the
    built library `kernel` that `namer` names (cuobjdump -res-usage)."""
    lib = str(build.library_path(kernel))
    report, name = {}, None
    usage = subprocess.run([str(tool), "-res-usage", lib], capture_output=True,
                           text=True, check=True).stdout
    for line in usage.splitlines():
        if "Function " in line:
            name = namer(line)
        elif name and "REG:" in line:
            num = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            report[name] = {"registers": num["REG"], "stack_bytes":
                            num["STACK"], "local_bytes": num["LOCAL"]}
            name = None
    return report


KV_MANGLED = {"f": "float", "13__nv_bfloat16": "bf16", "a": "int8"}


def decode_kernel_name(text):
    """`ragged_decode_kernel<16, bf16>` for a mangled decode kernel name
    (template arguments: the mirror copy width, the K/V type), the long
    route's `long_score_kernel<16>` and `long_race_kernel<bf16>`, or
    None."""
    m = re.search(r"(ragged|fused)_decode_kernelILi(\d+)E(f|a|13__nv_bfloat16)"
                  r"EEv", text)
    if m:
        return (f"{m.group(1)}_decode_kernel<{m.group(2)}, "
                f"{KV_MANGLED[m.group(3)]}>")
    m = re.search(r"long_score_kernelILi(\d+)EE", text)
    if m:
        return f"long_score_kernel<{m.group(1)}>"
    m = re.search(r"long_race_kernelI(f|a|13__nv_bfloat16)EE", text)
    return f"long_race_kernel<{KV_MANGLED[m.group(1)]}>" if m else None


def decode_kernel_report():
    """Registers, stack and local memory (spills) of every instantiation
    of the two decode kernels, printed; fails when one spills or a served
    one (16-byte mirror copies, bf16 and int8 K/V) is missing. Returns the
    served ones' numbers."""
    tool = cuobjdump()
    if tool is None:
        print("[build] cuobjdump not found: decode kernels' registers and "
              "spills not measured")
        return {}
    report = {}
    for kernel in ("ragged_decode", "fused_decode"):
        report.update({(f"{kernel} {n}" if n.startswith("long") else n): r
                       for n, r in res_usage(tool, kernel,
                                             decode_kernel_name).items()})
    for name in sorted(report):
        r = report[name]
        print(f"[build] {name}: {r['registers']} registers, "
              f"{r['stack_bytes']} B stack, {r['local_bytes']} B local "
              "(spills) (cuobjdump)")
    served = {k: {f"{kernel}_decode_kernel<16, {kv}>" for kv in
                  ("bf16", "int8")} for k, kernel in
              (("ragged_decode", "ragged"), ("fused_decode", "fused"))}
    served.update({f"{k}_long": {f"{k} long_score_kernel<16>", *(
        f"{k} long_race_kernel<{kv}>" for kv in ("bf16", "int8"))}
        for k in ("ragged_decode", "fused_decode")})
    for kernel, names in served.items():
        assert names <= set(report), (kernel, sorted(report))
    for name, r in report.items():
        assert r["stack_bytes"] == r["local_bytes"] == 0, (name, "spills")
    return {k: {"compiled": {n: report[n] for n in sorted(names)}}
            for k, names in served.items()}


def prompt_kernel_report():
    """Registers, stack and local memory (spills) of the prompt kernel's
    routes and the HMMA instructions in their SASS, read by cuobjdump from
    the built library, printed for the served instantiations and the f32
    route. Fails when a tensor-core kernel holds no HMMA or spills, or the
    served ones are missing. Returns the served ones' numbers."""
    tool = cuobjdump()
    if tool is None:
        print("[build] cuobjdump not found: registers, spills and HMMA count "
              "not measured")
        return {"compiled": "not measured"}
    lib = str(build.library_path("flash_prefill"))
    report = res_usage(tool, "flash_prefill", prompt_kernel_name)
    for r in report.values():
        r["hmma"] = r["hgmma"] = 0
    name = None
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for line in sass.splitlines():
        if "Function :" in line:
            name = prompt_kernel_name(line)
        elif name and "HMMA" in line:
            report[name]["hmma"] += 1
        elif name and "HGMMA" in line:
            report[name]["hgmma"] += 1
    for name in (*SERVED_TC, LATENT_TC, "flash_prefill_f32_kernel"):
        r = report.get(name, {})
        print(f"[build] {name}: {r.get('registers')} registers, "
              f"{r.get('stack_bytes')} B stack, {r.get('local_bytes')} B "
              f"local (spills), {r.get('hmma')} HMMA and {r.get('hgmma')} "
              "HGMMA (warpgroup) instructions in its SASS (cuobjdump)")
    tc = {n: r for n, r in report.items() if n.startswith("flash_prefill_tc")}
    spilled = {r["stack_bytes"] + r["local_bytes"] for r in tc.values()}
    print(f"[build] the {len(tc)} tensor-core instantiations (head dims 16 "
          f"to 128, both contracts): HMMA counts "
          f"{sorted({r['hmma'] for r in tc.values()})}, registers "
          f"{sorted({r['registers'] for r in tc.values()})}, stack + local "
          f"bytes {sorted(spilled)}")
    assert all(n in report for n in (*SERVED_TC, LATENT_TC)), sorted(report)
    for name, r in tc.items():
        assert r["hmma"] > 0, (name, "no tensor-core instruction")
        assert r["stack_bytes"] == r["local_bytes"] == 0, (name, "spills")
    # the latent route's products are warpgroup wgmma (HGMMA), no spill
    latent = report[LATENT_TC]
    assert latent["hgmma"] > 0, (LATENT_TC, "no wgmma")
    assert latent["stack_bytes"] == latent["local_bytes"] == 0, \
        (LATENT_TC, "spills")
    return {"compiled": {n: report[n] for n in (*SERVED_TC, LATENT_TC)}}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, and its time
# ---------------------------------------------------------------------------


# the main path's decode shape: 4 lanes x 32 heads, S = 1088, select_k =
# 128, fills as the served prompts leave them (1024 kept, + decode; the
# 682-token prompt keeps all 682)
MAIN_FILLS = [f for f in (1040, 1030, 1050, 690) for _ in range(32)]


def kernel_inputs(bh, g, d, s, fills, kv_dtype, seed):
    """Decode-step inputs on the card; slots at or past a row's fill are
    invalid, as the cache keeps them; ~10% of live slots protected."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    fills = torch.as_tensor(fills, dtype=torch.int32, device=dev)
    valid = (torch.arange(s, device=dev)[None, :]
             < fills[:, None]).to(torch.int8)
    prot = (torch.rand((bh, s), generator=gen, device=dev)
            < 0.1).to(torch.int8) * valid

    def codes(*shape, hi=8):
        return torch.randint(-hi + 1, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    if kv_dtype == torch.int8:
        k, v = codes(bh, s, d, hi=128), codes(bh, s, d, hi=128)
        ks = torch.rand((bh, s), generator=gen, device=dev) * 0.02 + 0.001
        vs = torch.rand((bh, s), generator=gen, device=dev) * 0.02 + 0.001
    else:
        k = torch.randn((bh, s, d), generator=gen, device=dev).to(kv_dtype)
        v = torch.randn((bh, s, d), generator=gen, device=dev).to(kv_dtype)
        ks = torch.ones((bh, s), device=dev)
        vs = ks
    args = [torch.randn((bh, g, d), generator=gen, device=dev),
            codes(bh, g, d),
            torch.rand((bh, g), generator=gen, device=dev) + 0.05,
            codes(bh, s, d),
            torch.rand((bh, s), generator=gen, device=dev) + 0.05,
            ks, vs, valid, prot, k, v]
    return fills, args


def set_inputs(bh, g, d, s, fills, kv_dtype, seed):
    """Decode-step inputs on the card whose out names the winner set:
    every K row of a lane equal (each valid winner weighs 1/n), V = 1 and
    vscale[s] = s + 1, so out is the mean of the winners' s + 1 and one
    wrong winner moves it by at least 1/select_k. Mirror codes in {0, 1},
    query codes in {-1, 0, 1} and equal scales tie the selection sums in
    runs; ~15% of live slots protected, and every valid slot of the last
    two rows (more protected slots than select_k where the fill allows)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    fills = torch.as_tensor(fills, dtype=torch.int32, device=dev)
    valid = (torch.arange(s, device=dev)[None, :]
             < fills[:, None]).to(torch.int8)
    prot = (torch.rand((bh, s), generator=gen, device=dev)
            < 0.15).to(torch.int8) * valid
    prot[-2:] = valid[-2:]
    if kv_dtype == torch.int8:
        krow = torch.randint(-127, 128, (bh, 1, d), generator=gen,
                             device=dev, dtype=torch.int8)
        ks = torch.full((bh, s), 0.01, device=dev)
    else:
        krow = torch.randn((bh, 1, d), generator=gen, device=dev).to(kv_dtype)
        ks = torch.ones((bh, s), device=dev)
    vs = (torch.arange(s, device=dev, dtype=torch.float32) + 1).expand(
        bh, s).contiguous()
    args = [torch.randn((bh, g, d), generator=gen, device=dev),
            torch.randint(-1, 2, (bh, g, d), generator=gen, device=dev,
                          dtype=torch.int8),
            torch.full((bh, g), 0.5, device=dev),
            (torch.rand((bh, s, d), generator=gen, device=dev)
             < 0.08).to(torch.int8),
            torch.full((bh, s), 0.25, device=dev), ks, vs, valid, prot,
            krow.expand(bh, s, d).contiguous(),
            torch.ones((bh, s, d), dtype=kv_dtype, device=dev)]
    return fills, args


def input_tag(make, k):
    return ("" if make is kernel_inputs else
            f" tie-heavy set (a wrong winner moves out >= 1/k = {1 / k:.3g})")


def ragged_bound(fills, args, select_k):
    """(bound_ms, bound_by) for one call on these inputs: each input byte
    the function needs read once, each output written once. A row needs
    its live mirror rows and their scale and valid bytes, the whole prot
    row, and the K/V rows and scales of at most min(select_k, fill)
    winners; the integer scores and the f32 attention are the operations."""
    q, qq, qscale, mirror, mscale, ks, vs, valid, prot, k, v = args
    bh, g, d = q.shape
    s, dv = mirror.shape[1], v.shape[-1]
    live = torch.clamp(fills.long(), max=s).cpu().numpy()
    wins = np.minimum(live, select_k)
    kvb = k.element_size()
    per_row_fixed = (g * d * 4 + g * d + g * 4 + 4 + s      # q, qq, qs, fill, prot
                     + g * dv * 4 + s * 4)                   # out, probs
    nbytes = int((per_row_fixed + live * (d + 4 + 1)
                  + wins * ((d + dv) * kvb + 8)).sum())
    t, by = bound(nbytes, float((2 * g * d * live).sum()),
                  float((2 * g * wins * (d + dv)).sum()))
    return t, by, nbytes


def mixed_fills(bh, s, k, seed):
    """0 (a free lane), below select_k, not a multiple of the block, full,
    then random."""
    head = [0, k - 5, 333 if s > 333 else s - 3, s]
    rest = np.random.default_rng(seed).integers(1, s + 1, bh - len(head))
    return head + rest.tolist()


def phase_ragged():
    cases = [  # name, BH, G, d, S, select_k
        ("longchat S=576", 4 * 32, 1, 128, 576, 64),
        ("longchat S=1088", 4 * 32, 1, 128, 1088, 128),
        ("granite-like GQA", 4 * 8, 4, 64, 576, 64),
        # a long cache: smaller ring tiles, winners staged in chunks
        ("longchat S=16384", 16, 1, 128, 16384, 128),
        # starcoder2-3b's and grok-1-314b's served decode shapes
        ("starcoder2 G=12", 4 * 2, 12, 128, 1088, 128),
        ("grok G=6", 4 * 8, 6, 128, 1088, 128),
        # zamba2-7b's shared attention block, served
        ("zamba2 d=112 S=1088", 4 * 32, 1, 112, 1088, 128),
        # whisper-base's decoder self-attention, served
        ("whisper d=64 S=1088", 4 * 8, 1, 64, 1088, 128),
    ]
    worst = 0.0
    for (ci, (name, bh, g, d, s, k)), kv, make in itertools.product(
            enumerate(cases), (torch.bfloat16, torch.int8),
            (kernel_inputs, set_inputs)):
        fills, args = make(bh, g, d, s, mixed_fills(bh, s, k, ci), kv,
                           seed=ci)
        out, probs = ragged_mod.ragged_decode(fills, *args, select_k=k)
        torch.cuda.synchronize()
        out_r, probs_r = ref.fused_decode_ref(*args, select_k=k)
        e_out = float((out - out_r).abs().max())
        e_probs = float((probs - probs_r).abs().max())
        free = fills == 0
        print(f"  {name} G={g} d={d} k={k} {str(kv)[6:]}{input_tag(make, k)}: "
              f"max|dout|={e_out:.3g} max|dprobs|={e_probs:.3g} free-lane "
              f"out/probs all zero="
              f"{not out[free].any() and not probs[free].any()}")
        assert e_out <= OUT_ATOL, (name, kv, make, e_out)
        assert e_probs <= PROBS_ATOL, (name, kv, make, e_probs)
        assert torch.isfinite(out).all() and torch.isfinite(probs).all()
        assert not out[free].any() and not probs[free].any()
        worst = max(worst, e_out, e_probs)

    timings = {}
    for kv in (torch.bfloat16, torch.int8):
        sets = [kernel_inputs(128, 1, 128, 1088, MAIN_FILLS, kv, seed=9 + i)
                for i in range(COLD_SETS)]
        fills, args = sets[0]

        def call(fl, *a):
            return ragged_mod.ragged_decode(fl, *a, select_k=128)

        ms = cuda_ms(lambda: call(fills, *args))
        cold = cold_ms(call, [(f, *a) for f, a in sets])
        wall = call_ms(lambda: call(fills, *args))
        plain = cuda_ms(lambda: ref.fused_decode_ref(*args, select_k=128))
        t, by, nbytes = ragged_bound(fills, args, 128)
        timings[str(kv)[6:]] = (cold, plain, t, by, None)
        timings[f"{str(kv)[6:]} warm"] = (ms, wall)
        print(f"  time main shape (BH=128 G=1 d=128 S=1088 k=128 "
              f"{str(kv)[6:]}): kernel {cold:.4f} ms with L2 cold "
              f"({COLD_SETS} input sets in turn; {ms:.4f} ms with its inputs "
              "in L2; "
              f"{wall:.4f} ms a call with the wrapper's host time), plain "
              f"{plain:.4f} ms, bound {t:.4f} ms ({by}: {nbytes} B at "
              "3.35 TB/s); library call: none (no single PyTorch call "
              "computes this function)")
    timings["g12"] = g12_times("ragged_decode", lambda fl, *a: (
        ragged_mod.ragged_decode(fl, *a, select_k=128)),
        lambda fl, *a: ref.fused_decode_ref(*a, select_k=128),
        lambda fl, a: ragged_bound(fl, a, 128))
    timings["d112"] = d112_times("ragged_decode", lambda fl, *a: (
        ragged_mod.ragged_decode(fl, *a, select_k=128)),
        lambda fl, *a: ref.fused_decode_ref(*a, select_k=128),
        lambda fl, a: ragged_bound(fl, a, 128))
    timings["d64"] = d64_times("ragged_decode", lambda fl, *a: (
        ragged_mod.ragged_decode(fl, *a, select_k=128)),
        lambda fl, *a: ref.fused_decode_ref(*a, select_k=128),
        lambda fl, a: ragged_bound(fl, a, 128))
    return worst, timings


# starcoder2-3b's served decode: 4 lanes x 2 kv-heads, G = 12, S = 1088
G12_FILLS = [f for f in (1040, 1030, 1050, 690) for _ in range(2)]
L2_BYTES = 50e6


def g12_times(name, call, plain, bound_of):
    """Card times of a decode kernel at starcoder2-3b's served shape, bf16
    and int8 K/V: with L2 cold (enough input sets in turn to hold twice the
    L2, as many as the 8 rows' ~5 MB sets need), with its inputs in L2,
    its plain version, and the bound on the first set."""
    return shape_times(name, "starcoder2-3b", 8, 12, 128, G12_FILLS, 40,
                       call, plain, bound_of)


def d112_times(name, call, plain, bound_of):
    """The same at zamba2-7b's served decode shape: 4 lanes x 32 heads of
    d = 112, G = 1, S = 1088, the served fills."""
    return shape_times(name, "zamba2-7b", 128, 1, 112, MAIN_FILLS, 60, call,
                       plain, bound_of)


# whisper-base's served decode: 4 lanes x 8 heads of d = 64, G = 1, four
# equal 2,048-token prompts pruned to 1,024 rows, 16 steps in
WHISPER_FILLS = [1040] * (4 * 8)


def d64_times(name, call, plain, bound_of):
    """The same at whisper-base's served decode shape: BH = 32, d = 64,
    G = 1, S = 1088."""
    return shape_times(name, "whisper-base", 32, 1, 64, WHISPER_FILLS, 80,
                       call, plain, bound_of)


def shape_times(name, model, bh, g, d, fills, seed, call, plain, bound_of):
    """Card times of a decode kernel at one served shape (BH rows of G
    query rows, head dim d, S = 1088, k = 128), bf16 and int8 K/V: with L2
    cold (at least COLD_SETS input sets in turn, enough to hold twice the
    L2), with its inputs in L2, its plain version, and the bound on the
    first set."""
    out = {}
    for kv in (torch.bfloat16, torch.int8):
        first = kernel_inputs(bh, g, d, 1088, fills, kv, seed=seed)
        nbytes = sum(a.numel() * a.element_size() for a in first[1])
        n_sets = max(COLD_SETS, math.ceil(2 * L2_BYTES / nbytes))
        sets = [first] + [kernel_inputs(bh, g, d, 1088, fills, kv,
                                        seed=seed + i)
                          for i in range(1, n_sets)]
        fills, args = first
        warm = cuda_ms(lambda: call(fills, *args))
        cold = cold_ms(call, [(f, *a) for f, a in sets])
        plain_ms = cuda_ms(lambda: plain(fills, *args))
        t, by, nb = bound_of(fills, args)
        key = str(kv)[6:]
        out[key] = {"ms": cold, "ms_l2_warm": warm, "plain_ms": plain_ms,
                    "bound_ms": t, "bound_by": by}
        print(f"  time {model} shape (BH={bh} G={g} d={d} S=1088 k=128 "
              f"{key}) {name}: kernel {cold:.4f} ms with L2 cold ({n_sets} "
              f"input sets in turn; {warm:.4f} ms with its inputs in L2), "
              f"plain {plain_ms:.4f} ms, bound {t:.4f} ms ({by}: {nb} B)")
    return out


def fused_bound(args, select_k, nb):
    """(bound_ms, bound_by, bytes) of one fused_decode call on these
    inputs: each row's valid mirror rows with their scale, the valid and
    prot bytes, the K/V rows and scales of the valid winners (per block at
    most k_loc, at most its valid slots), q, qq, qscale, out and probs."""
    q, qq, qscale, mirror, mscale, ks, vs, valid, prot, k, v = args
    bh, g, d = q.shape
    s, dv = mirror.shape[1], v.shape[-1]
    per_block = valid.reshape(bh, nb, s // nb).sum(-1).long()
    wins = torch.clamp(per_block, max=select_k // nb).sum(-1).cpu().numpy()
    live = valid.sum(-1).long().cpu().numpy()
    nbytes = int((g * d * 4 + g * d + g * 4 + 2 * s + g * dv * 4 + s * 4
                  + live * (d + 4)
                  + wins * ((d + dv) * k.element_size() + 8)).sum())
    t, by = bound(nbytes, float((2 * g * d * live).sum()),
                  float((2 * g * wins * (d + dv)).sum()))
    return t, by, nbytes


def phase_fused():
    """fused_decode against its plain version: nb in {1, 2, 4, 8} directly,
    and nb = 3 (1088 = 3 x 362 + 2: a ragged tail) through ops; timed at
    the served shape with nb = 4."""
    cases = [  # name, BH, G, d, S, select_k
        ("longchat S=1088", 4 * 32, 1, 128, 1088, 128),
        ("granite-like GQA S=1088", 4 * 8, 4, 64, 1088, 128),
        ("granite-like GQA S=8256", 8, 4, 64, 8256, 128),
        ("starcoder2 G=12 S=1088", 4 * 2, 12, 128, 1088, 128),
        ("zamba2 d=112 S=1088", 4 * 32, 1, 112, 1088, 128),
        ("whisper d=64 S=1088", 4 * 8, 1, 64, 1088, 128),
    ]
    worst = 0.0
    for (ci, (name, bh, g, d, s, k)), kv, make in itertools.product(
            enumerate(cases), (torch.bfloat16, torch.int8),
            (kernel_inputs, set_inputs)):
        fills, args = make(bh, g, d, s, mixed_fills(bh, s, k, ci), kv,
                           seed=10 + ci)
        free = fills == 0
        for nb in (1, 2, 4, 8, 3):
            if nb == 3:      # select_k divisible by 3, S padded by ops
                kk = k - k % 3
                out, probs = ops.fused_decode(*args, select_k=kk,
                                              num_blocks=nb)
                pad = [F.pad(a, [0, 0] * (a.dim() - 2) + [0, -s % nb])
                       for a in args[3:]]
                out_r, probs_r = ref.fused_decode_ref(
                    *args[:3], *pad, select_k=kk, num_blocks=nb)
                probs_r = probs_r[:, :s]
            else:
                kk = k
                out, probs = fused_mod.fused_decode(*args, select_k=k,
                                                    num_blocks=nb)
                out_r, probs_r = ref.fused_decode_ref(
                    *args, select_k=k, num_blocks=nb)
            torch.cuda.synchronize()
            e_out = float((out - out_r).abs().max())
            e_probs = float((probs - probs_r).abs().max())
            print(f"  {name} G={g} d={d} k={kk} nb={nb} {str(kv)[6:]}"
                  f"{input_tag(make, kk)}: max|dout|={e_out:.3g} "
                  f"max|dprobs|={e_probs:.3g}")
            assert e_out <= OUT_ATOL, (name, kv, nb, e_out)
            assert e_probs <= PROBS_ATOL, (name, kv, nb, e_probs)
            assert torch.isfinite(out).all() and torch.isfinite(probs).all()
            assert not out[free].any() and not probs[free].any()
            worst = max(worst, e_out, e_probs)
    timings = {}
    for kv in (torch.bfloat16, torch.int8):
        sets = [kernel_inputs(128, 1, 128, 1088, MAIN_FILLS, kv, seed=9 + i)[1]
                for i in range(COLD_SETS)]
        args = sets[0]

        def call(*a):
            return fused_mod.fused_decode(*a, select_k=128, num_blocks=4)

        ms = cuda_ms(lambda: call(*args))
        cold = cold_ms(call, sets)
        wall = call_ms(lambda: call(*args))
        plain = cuda_ms(lambda: ref.fused_decode_ref(*args, select_k=128,
                                                     num_blocks=4))
        t, by, nbytes = fused_bound(args, 128, 4)
        timings[str(kv)[6:]] = (cold, plain, t, by, None)
        timings[f"{str(kv)[6:]} warm"] = (ms, wall)
        print(f"  time main shape (BH=128 G=1 d=128 S=1088 k=128 nb=4 "
              f"{str(kv)[6:]}): kernel {cold:.4f} ms with L2 cold "
              f"({COLD_SETS} input sets in turn; {ms:.4f} ms with its inputs "
              "in L2; "
              f"{wall:.4f} ms a call with the wrapper's host time), plain "
              f"{plain:.4f} ms, bound {t:.4f} ms ({by}: {nbytes} B at "
              "3.35 TB/s); library call: none (no single PyTorch call "
              "scores, races and attends)")
    timings["g12"] = g12_times("fused_decode nb=4", lambda fl, *a: (
        fused_mod.fused_decode(*a, select_k=128, num_blocks=4)),
        lambda fl, *a: ref.fused_decode_ref(*a, select_k=128, num_blocks=4),
        lambda fl, a: fused_bound(a, 128, 4))
    timings["d112"] = d112_times("fused_decode nb=4", lambda fl, *a: (
        fused_mod.fused_decode(*a, select_k=128, num_blocks=4)),
        lambda fl, *a: ref.fused_decode_ref(*a, select_k=128, num_blocks=4),
        lambda fl, a: fused_bound(a, 128, 4))
    timings["d64"] = d64_times("fused_decode nb=4", lambda fl, *a: (
        fused_mod.fused_decode(*a, select_k=128, num_blocks=4)),
        lambda fl, *a: ref.fused_decode_ref(*a, select_k=128, num_blocks=4),
        lambda fl, a: fused_bound(a, 128, 4))
    return worst, timings


# ---------------------------------------------------------------------------
# phase 3: the decode kernels' long route, alone
# ---------------------------------------------------------------------------

# decode_32k and long_500k as the reference's dry run prunes them
# (`make_prune`, src/repro/launch/dryrun.py:62, over SHAPES,
# src/repro/configs/base.py:274): slots = seq_len, heavy = slots - 64,
# select_k = min(2048, slots // 16); BH = one lane's kv-heads
LONG_K = 2048
LONG_SHAPES = (  # name, BH, G, d, S
    ("longchat-7b decode_32k", 32, 1, 128, 32768),
    ("granite-3-2b decode_32k", 8, 4, 64, 32768),
    ("starcoder2-3b S=32768", 2, 12, 128, 32768),
    ("granite-3-2b long_500k", 8, 4, 64, 524288),
)
LONG_NB = 4                        # fused_decode's selection blocks there


def long_fills(bh, s, k, seed):
    """Full, ragged (no multiple of the skip block), free (0) and below
    select_k, then random."""
    head = [s, s - 777, 0, k - 5][:bh]
    rest = np.random.default_rng(seed).integers(1, s + 1, bh - len(head))
    return head + rest.tolist()


def bits_inputs(bh, g, d, s, fills, kv_dtype, seed):
    """`set_inputs` (tie-heavy selection sums, a lane's K rows equal) with
    V[s][c] = bit c of s and vscale = 1: n * out[c] counts the valid
    winners whose slot has bit c set, an integer that one wrong winner
    moves by 1 (`winner_bits`)."""
    fills, args = set_inputs(bh, g, d, s, fills, kv_dtype, seed)
    slot = torch.arange(s, device="cuda")
    bits = (slot[:, None] >> torch.arange(d, device="cuda")[None, :]) & 1
    args[6] = torch.ones((bh, s), device="cuda")
    args[10] = bits.to(kv_dtype).expand(bh, s, d).contiguous()
    return fills, args


def winner_bits(args, select_k, nb):
    """The plain race's (`ref.decode_race`) valid winners on `bits_inputs`
    → (n [BH], the count of them with bit c set [BH, d]): n * out of a
    kernel that picked the same winners, rounded."""
    q, qq, qs, mirror, ms, ks, vs, valid, prot, k, v = args
    _, idx = ref.decode_race(qq, qs, mirror, ms, valid, prot,
                             select_k=select_k, num_blocks=nb)
    ok = torch.gather(valid, 1, idx) != 0
    bits = (idx[..., None] >> torch.arange(v.shape[-1], device="cuda")) & 1
    return ok.sum(-1), (bits * ok[..., None]).sum(1)


def probs_at_scale(probs, probs_r, live, g):
    """(worst |probs - probs_r| / (|probs_r| + G / live of its row), worst
    |row sum - G| / G, the sum wanted 0 for a row with no live slot) for
    probs [BH, S] against the plain version's, `live` [BH, S] bool."""
    p, pr = probs.double(), probs_r.double()
    n = live.sum(-1, keepdim=True).double()
    err = float(((p - pr).abs() / (pr.abs() + g / n.clamp(min=1))).max())
    want = (n[:, 0] > 0).double() * g
    return err, float((p.sum(-1) - want).abs().max()) / g


def long_check(name, key, call, args, fills, k, nb, make, kv):
    """One long-route kernel against its plain version: two launches, both
    counted under `key` and nothing else, bit-equal; out and probs within
    OUT_ATOL / PROBS_ATOL, probs also at its own scale (`probs_at_scale`:
    PROBS_RTOL, PROBS_SUM_RTOL); free rows zero, probs zero past each
    fill; on `bits_inputs` the winner set the plain race's. → the worst
    error."""
    reset_launches()
    out, probs = call()
    out2, probs2 = call()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts.pop(key) == 2 and not any(counts.values()), (key, counts)
    out_r, probs_r = ref.fused_decode_ref(*args, select_k=k, num_blocks=nb)
    e_out = float((out - out_r).abs().max())
    e_probs = float((probs - probs_r).abs().max())
    same = torch.equal(out, out2) and torch.equal(probs, probs2)
    dead = torch.arange(probs.shape[1], device="cuda")[None] >= fills[:, None]
    free = fills == 0
    e_scale, e_sum = probs_at_scale(probs, probs_r, (args[7] != 0) & ~dead,
                                    args[0].shape[1])
    tag = ""
    if make is bits_inputs:
        n, want = winner_bits(args, k, nb)
        got = torch.round(out.double() * n[:, None, None].double())
        winners = torch.equal(got, want[:, None, :].double().expand_as(got))
        tag = f", winner sets the plain race's: {winners}"
        assert winners, (name, key, kv)
    print(f"  {name} {key}{f' nb={nb}' if nb > 1 else ''} {str(kv)[6:]}"
          f"{' slot-bit set' if make is bits_inputs else ''}: "
          f"max|dout|={e_out:.3g} max|dprobs|={e_probs:.3g}, at scale "
          f"{e_scale:.3g} (row sums {e_sum:.3g}), two launches "
          f"bit-equal: {same}{tag}")
    assert e_out <= OUT_ATOL and e_probs <= PROBS_ATOL, (name, key, kv)
    assert e_scale <= PROBS_RTOL and e_sum <= PROBS_SUM_RTOL, (name, key, kv)
    assert same and torch.isfinite(out).all() and torch.isfinite(probs).all()
    assert not out[free].any() and not probs[dead].any()
    return max(e_out, e_probs)


def phase_long_kernels():
    """Both decode kernels' long route against their plain versions at the
    long shapes (LONG_SHAPES), bf16 and int8 K/V, random and slot-bit
    inputs, ragged_decode and fused_decode with LONG_NB blocks; then their
    times with L2 cold (input sets in turn) beside the plain version and
    the bound. → ({kernel: worst error}, {kernel: timings})."""
    worst = {"ragged_decode_long": 0.0, "fused_decode_long": 0.0}
    times = {"ragged_decode_long": {}, "fused_decode_long": {}}
    for (ci, (name, bh, g, d, s)), kv in itertools.product(
            enumerate(LONG_SHAPES), (torch.bfloat16, torch.int8)):
        fl = long_fills(bh, s, LONG_K, ci)
        for make in (kernel_inputs, bits_inputs):
            fills, args = make(bh, g, d, s, fl, kv, seed=100 + ci)
            worst["ragged_decode_long"] = max(
                worst["ragged_decode_long"], long_check(
                    name, "ragged_decode_long", lambda: ragged_mod.
                    ragged_decode(fills, *args, select_k=LONG_K), args,
                    fills, LONG_K, 1, make, kv))
            worst["fused_decode_long"] = max(
                worst["fused_decode_long"], long_check(
                    name, "fused_decode_long", lambda: fused_mod.
                    fused_decode(*args, select_k=LONG_K, num_blocks=LONG_NB),
                    args, fills, LONG_K, LONG_NB, make, kv))
            del args
        first = kernel_inputs(bh, g, d, s, fl, kv, seed=200 + ci)
        nbytes = sum(a.numel() * a.element_size() for a in first[1])
        sets = [first] + [kernel_inputs(bh, g, d, s, fl, kv, seed=200 + ci + i)
                          for i in range(1, max(2, math.ceil(
                              2 * L2_BYTES / nbytes)))]
        fills, args = first
        for key, call, plain, bound_of in (
                ("ragged_decode_long", lambda f, *a: ragged_mod.ragged_decode(
                    f, *a, select_k=LONG_K),
                 lambda: ref.fused_decode_ref(*args, select_k=LONG_K),
                 lambda: ragged_bound(fills, args, LONG_K)),
                ("fused_decode_long", lambda f, *a: fused_mod.fused_decode(
                    *a, select_k=LONG_K, num_blocks=LONG_NB),
                 lambda: ref.fused_decode_ref(*args, select_k=LONG_K,
                                              num_blocks=LONG_NB),
                 lambda: fused_bound(args, LONG_K, LONG_NB))):
            cold = cold_ms(call, [(f, *a) for f, a in sets])
            plain_ms = cuda_ms(plain, iters=5, warmup=1)
            t, by, nb_bytes = bound_of()
            times[key][f"{name} {str(kv)[6:]}"] = {
                "ms": cold, "plain_ms": plain_ms, "bound_ms": t,
                "bound_by": by}
            print(f"  time {name} (BH={bh} G={g} d={d} S={s} k={LONG_K} "
                  f"{str(kv)[6:]}) {key}"
                  f"{f' nb={LONG_NB}' if 'fused' in key else ''}: kernel "
                  f"{cold:.4f} ms with L2 cold ({len(sets)} input sets in "
                  f"turn), plain {plain_ms:.4f} ms, bound {t:.4f} ms ({by}: "
                  f"{nb_bytes} B at 3.35 TB/s); library call: none")
        del sets, first, args
        torch.cuda.empty_cache()
    return worst, times


def score_inputs(bh, g, d, s, fills, seed, q_hi=128, k_hi=128, holes=0.0):
    """qq, qscale, kq, kscale, valid: slots below a row's fill valid, less
    a `holes` share of them at random."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    fills = torch.as_tensor(fills, dtype=torch.int32, device=dev)
    valid = (torch.arange(s, device=dev)[None, :]
             < fills[:, None]).to(torch.int8)
    if holes:
        valid *= (torch.rand((bh, s), generator=gen, device=dev)
                  >= holes).to(torch.int8)
    qq = torch.randint(-q_hi + 1, q_hi, (bh, g, d), generator=gen,
                       device=dev, dtype=torch.int8)
    kq = torch.randint(-k_hi + 1, k_hi, (bh, s, d), generator=gen,
                       device=dev, dtype=torch.int8)
    qs = torch.rand((bh, g), generator=gen, device=dev) + 0.05
    ks = torch.rand((bh, s), generator=gen, device=dev) + 0.05
    return qq, qs, kq, ks, valid


def score_bound(qq, kq_row_bytes, valid):
    """qq, qscale, the valid rows of the mirror with their scale, the valid
    bytes and the [G, S] f32 output."""
    bh, g, d = qq.shape
    s = valid.shape[1]
    live = int(valid.sum())
    nbytes = (bh * (g * d + g * 4 + s + g * s * 4)
              + live * (kq_row_bytes + 4))
    t, by = bound(nbytes, int8_ops=2.0 * g * d * live)
    return t, by, nbytes


# the composed path's timed shapes (S = K... = 1088 slots, k = 128
# gathered rows): longchat-7b's served decode, a granite-like GQA one, and
# starcoder2-3b's G = 12
COMPOSED_SHAPES = (("longchat-7b", 128, 1, 128, MAIN_FILLS),
                   ("granite-like GQA", 32, 4, 64, MAIN_FILLS[::4]),
                   ("starcoder2-3b", 8, 12, 128, G12_FILLS))

def composed_kernel_name(text):
    """The demangled name of an approx_score or gather_attention kernel in
    a mangled one, or None."""
    m = re.search(r"approx_score_mma_kernelILi(\d+)ELb([01])E", text)
    if m:
        return (f"approx_score_mma_kernel<{m.group(1)}, "
                f"{'true' if m.group(2) == '1' else 'false'}>")
    m = re.search(r"gather_attention_kernelI(f|a|13__nv_bfloat16)Lb([01])E"
                  r"Li(\d+)E", text)
    if m:
        return (f"gather_attention_kernel<{KV_MANGLED[m.group(1)]}, "
                f"{'true' if m.group(2) == '1' else 'false'}, {m.group(3)}>")
    return None


# what phase 5's three-pass step launches (bf16 K/V, and f32 ones for an
# int8 cache), and the timed G = 4 and 12 shapes
SERVED_COMPOSED = ("approx_score_mma_kernel<16, false>",
                   "approx_score_mma_kernel<16, true>",
                   "gather_attention_kernel<bf16, true, 1>",
                   "gather_attention_kernel<float, true, 1>",
                   "gather_attention_kernel<bf16, true, 4>")


def composed_kernel_report():
    """Registers, stack and local memory (spills) of every instantiation of
    approx_score.cu and gather_attention.cu, printed; fails when one
    spills or a served one is missing. Returns the served ones'."""
    tool = cuobjdump()
    if tool is None:
        print("[build] cuobjdump not found: composed kernels' registers and "
              "spills not measured")
        return {}
    report = {}
    for kernel in ("approx_score", "gather_attention"):
        report.update(res_usage(tool, kernel, composed_kernel_name))
    for name in sorted(report):
        r = report[name]
        print(f"[build] {name}: {r['registers']} registers, "
              f"{r['stack_bytes']} B stack, {r['local_bytes']} B local "
              "(spills) (cuobjdump)")
    assert set(SERVED_COMPOSED) <= set(report), sorted(report)
    for name, r in report.items():
        assert r["stack_bytes"] == r["local_bytes"] == 0, (name, "spills")
    return {name: report[name] for name in SERVED_COMPOSED}


def misaligned(t, offset):
    """A contiguous copy of t whose data starts `offset` bytes past a
    256-byte boundary."""
    n = t.numel() * t.element_size()
    buf = torch.empty(n + 256, dtype=torch.uint8, device=t.device)
    out = buf[offset:offset + n].view(t.dtype).view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 256 == offset
    return out


def approx_check(name, qq, qs, kq, ks, valid, offset=0):
    """Both routes bit for bit against their plain versions, and two
    launches of each bit-equal (the int8 route's codes clamped into the
    packed route's [-8, 7]); offset: both mirrors start that many bytes
    past a 256-byte boundary."""
    packed = quant.pack_int4(torch.clamp(kq, -8, 7))
    if offset:
        kq, packed = misaligned(kq, offset), misaligned(packed, offset)
    got = approx_mod.approx_score(qq, qs, kq, ks, valid)
    again = approx_mod.approx_score(qq, qs, kq, ks, valid)
    want = ref.approx_score_ref(qq, qs, kq, ks, valid)
    got4 = approx_mod.approx_score_packed(qq, qs, packed, ks, valid)
    again4 = approx_mod.approx_score_packed(qq, qs, packed, ks, valid)
    want4 = ref.approx_score_packed_ref(qq, qs, packed, ks, valid)
    torch.cuda.synchronize()
    same, same4 = torch.equal(got, want), torch.equal(got4, want4)
    twice = torch.equal(got, again) and torch.equal(got4, again4)
    print(f"  {name}: approx_score bit-equal {same}, packed bit-equal "
          f"{same4}, two launches bit-equal {twice}")
    assert same and same4 and twice, name


# approx_score's edges: (name, BH, G, d, S, mirror offset, extreme); S is
# no multiple of the 32-slot item, and every row gets holes and an empty
# 32-slot tile. Load widths (int8 / packed rows of d / d/2 bytes): 16 / 16
# at d = 128, 64 and 256, 16 / 8 at d = 112, 8 / 4 at d = 40, and what a
# mirror's offset from 16-byte alignment leaves. extreme: every q at -128
# or 127 and every code at -8 or 7, with slots where |Σ| = 128·8·4096 =
# 2^22, the packed route's largest sum (16·Σ = 2^26 in its accumulator)
APPROX_EDGES = (("S=1045 G=1 d=128", 6, 1, 128, 1045, 0, False),
                ("S=77 G=16 d=128", 5, 16, 128, 77, 0, False),
                ("S=1088 G=16 d=64", 4, 16, 64, 1088, 0, False),
                ("S=333 G=3 d=112 (packed 8-byte loads)", 7, 3, 112, 333,
                 0, False),
                ("S=130 G=5 d=40 (8-byte loads, packed 4)", 3, 5, 40, 130,
                 0, False),
                ("S=259 G=16 d=256 (two k-chunks)", 3, 16, 256, 259, 0,
                 False),
                ("S=64 G=1 d=4096 (32 k-chunks)", 2, 1, 4096, 64, 0, False),
                ("S=64 G=1 d=4096, codes at the extremes", 2, 1, 4096, 64,
                 0, True),
                ("S=200 G=2 d=128, mirrors 8- but not 16-byte aligned "
                 "(8-byte loads)", 4, 2, 128, 200, 8, False),
                ("S=200 G=2 d=128, mirrors 4- but not 8-byte aligned "
                 "(4-byte loads)", 4, 2, 128, 200, 4, False))


def phase_approx():
    """approx_score and approx_score_packed against their plain versions:
    equal bit for bit at the three served shapes and at the edges of the
    int8 route's tiling; then `approx_times`."""
    for ci, (name, bh, g, d, s) in enumerate([
            ("longchat S=1088", 128, 1, 128, 1088),
            ("granite-like GQA S=1088", 32, 4, 64, 1088),
            ("starcoder2 G=12 S=1088", 8, 12, 128, 1088)]):
        fills = mixed_fills(bh, s, 128, ci)
        approx_check(f"{name} G={g} d={d}",
                     *score_inputs(bh, g, d, s, fills, 20 + ci))
    for ci, (name, bh, g, d, s, offset, extreme) in enumerate(
            APPROX_EDGES):
        fills = ([s, s - 13, s // 2, 0] * bh)[:bh]   # 0: an empty row
        qq, qs, kq, ks, valid = score_inputs(bh, g, d, s, fills, 40 + ci,
                                             holes=0.3)
        if s > 64:
            valid[:, 32:64] = 0        # a tile with no valid slot
        if extreme:
            qq = torch.where(qq < 0, -128, 127).to(torch.int8)
            kq = torch.where(kq < 0, -8, 7).to(torch.int8)
            qq[0] = -128               # row 0: Σ = 2^22 at its first slots
            kq[0, :s // 2] = -8
        approx_check(f"edge {name}", qq, qs, kq, ks, valid, offset)
    return 0.0, approx_times()


def approx_times():
    """Both routes timed at the three COMPOSED_SHAPES with inputs in L2 and
    with L2 cold, beside the plain version and the bound. Needs nothing of
    this script's other phases, so it also times another checkout's
    kernels: run it from that checkout's root."""
    timings = {"extra:approx_score": {}, "extra:approx_score_packed": {}}
    for si, (model, bh, g, d, fills) in enumerate(COMPOSED_SHAPES):
        # the served operands: 4-bit queries, a 3-bit mirror
        def make(seed):
            return score_inputs(bh, g, d, 1088, fills, seed, q_hi=8, k_hi=4)
        first = make(29 + 100 * si)
        nbytes = (sum(t.numel() * t.element_size() for t in first)
                  + bh * g * 1088 * 4)
        n_sets = max(COLD_SETS, math.ceil(2 * L2_BYTES / nbytes))
        sets = [first] + [make(29 + 100 * si + i) for i in range(1, n_sets)]
        for name, fn, plain_fn, row in (
                ("approx_score", approx_mod.approx_score,
                 ref.approx_score_ref, d),
                ("approx_score_packed", approx_mod.approx_score_packed,
                 ref.approx_score_packed_ref, d // 2)):
            if name.endswith("packed"):
                args = [(a, b, quant.pack_int4(c), e, f)
                        for a, b, c, e, f in sets]
            else:
                args = sets
            warm = cuda_ms(lambda: fn(*args[0]))
            cold = cold_ms(fn, args)
            plain = cuda_ms(lambda: plain_fn(*args[0]))
            t, by, nb = score_bound(args[0][0], row, args[0][4])
            res = {"ms": warm, "ms_l2_cold": cold, "plain_ms": plain,
                   "bound_ms": t, "bound_by": by}
            line = (f"kernel {warm:.4f} ms with its inputs in L2, {cold:.4f}"
                    f" ms with L2 cold ({n_sets} input sets in turn)")
            print(f"  time {name} {model} (BH={bh} G={g} d={d} S=1088): "
                  f"{line}; plain {plain:.4f} ms, bound {t:.4f} ms ({by}: "
                  f"{nb} B); library call: none (torch has no int8 x int8 "
                  "-> int32 batched product on the card)")
            if si == 0:
                timings[name] = (warm, plain, t, by, None)
                timings[f"extra:{name}"]["ms_l2_cold"] = cold
            else:
                timings[f"extra:{name}"][model] = res
    return timings


def gather_inputs(bh, g, d, kk, kv, seed, frac=0.6, dv=None):
    """q, k, v, valid: mixed rows, row 0 without a valid slot, row 1 all
    valid, row 2 (where there is one) with one valid slot. int8 K/V are raw
    codes, so q carries their 1/127 scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    dv = d if dv is None else dv
    q = torch.randn((bh, g, d), generator=gen, device=dev)
    if kv == torch.int8:
        q = q / 127
        k, v = (torch.randint(-127, 128, (bh, kk, w), generator=gen,
                              device=dev, dtype=torch.int8) for w in (d, dv))
    else:
        k, v = (torch.randn((bh, kk, w), generator=gen, device=dev).to(kv)
                for w in (d, dv))
    valid = (torch.rand((bh, kk), generator=gen, device=dev)
             < frac).to(torch.int8)
    valid[0], valid[1] = 0, 1
    if bh > 2:
        valid[2] = 0
        valid[2, kk // 2] = 1
    return q, k, v, valid


def gather_check(name, q, k, v, valid):
    """Within GATHER_ATOL of the plain version, finite, and two launches
    bit-equal; returns max|dout|."""
    out = gather_mod.gather_attention(q, k, v, valid)
    again = gather_mod.gather_attention(q, k, v, valid)
    want = ref.gather_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    twice = torch.equal(out, again)
    print(f"  {name}: max|dout|={err:.3g}, two launches bit-equal {twice}")
    assert err <= GATHER_ATOL and torch.isfinite(out).all(), name
    assert twice, name
    return err


def gather_kmax(g, d):
    """The largest K whose [G][d] query and [G][K] logits (and 32 bytes)
    fit in the shared memory a CTA may opt into: what the wrapper admits."""
    lib = gather_mod._bind(build.load("gather_attention"))
    props = torch.cuda.get_device_properties(0)
    limit = int(getattr(props, "shared_memory_per_block_optin", 232448))
    kk = (limit - 32 - 4 * g * d) // (4 * g)
    assert lib.gather_attention_smem_bytes(kk, g, d) <= limit
    assert lib.gather_attention_smem_bytes(kk + 1, g, d) > limit
    return kk


def gather_bound(q, k, v, valid):
    """q, the valid bytes and out; the valid K and V rows (all V rows of a
    row with no valid slot); 2·G·(d + dv) flops a row read."""
    bh, g, d = q.shape
    kk, dv = k.shape[1], v.shape[-1]
    nv = valid.sum(-1).long()
    rows_k = int(nv.sum())
    rows_v = int(torch.where(nv > 0, nv, torch.full_like(nv, kk)).sum())
    nbytes = (bh * (g * d * 4 + kk + g * dv * 4)
              + rows_k * d * k.element_size() + rows_v * dv * v.element_size())
    t, by = bound(nbytes, f32_flops=2.0 * g * (rows_k * d + rows_v * dv))
    return t, by, nbytes


def phase_gather():
    """gather_attention against its plain version (rows with no valid slot
    get the mean of their V rows, as the oracle): the three served shapes,
    then the edges of the design; then `gather_times`."""
    worst = 0.0
    for ci, (name, bh, g, d) in enumerate([("longchat", 128, 1, 128),
                                           ("granite-like GQA", 32, 4, 64),
                                           ("starcoder2", 8, 12, 128)]):
        for kv in (torch.bfloat16, torch.int8):
            worst = max(worst, gather_check(
                f"{name} G={g} d={d} K=128 {str(kv)[6:]}",
                *gather_inputs(bh, g, d, 128, kv, 30 + ci)))
    edges = [  # name, bh, g, d, K, dtype, dv
        ("K=40 G=16 d=64 f32", 6, 16, 64, 40, torch.float32, 64),
        ("K=129 G=16 d=128 bf16", 6, 16, 128, 129, torch.bfloat16, 128),
        ("K=300 G=3 d=112 int8", 6, 3, 112, 300, torch.int8, 112),
        ("K=129 G=1 d=112 bf16", 6, 1, 112, 129, torch.bfloat16, 112),
        ("K=257 G=12 d=64 bf16", 6, 12, 64, 257, torch.bfloat16, 64),
        ("K=200 G=4 d=128 dv=64 f32", 6, 4, 128, 200, torch.float32, 64),
        ("K=1024 G=1 d=128 f32 (past the stage)", 4, 1, 128, 1024,
         torch.float32, 128),
        ("K=700 G=16 d=128 bf16 (past the stage)", 4, 16, 128, 700,
         torch.bfloat16, 128),
        ("K=130 G=2 d=40 int8 (element-wise)", 6, 2, 40, 130, torch.int8,
         40),
        ("K=77 G=5 d=36 bf16 dv=20 (element-wise)", 6, 5, 36, 77,
         torch.bfloat16, 20),
    ]
    for ci, (name, bh, g, d, kk, kv, dv) in enumerate(edges):
        worst = max(worst, gather_check(f"edge {name}", *gather_inputs(
            bh, g, d, kk, kv, 60 + ci, dv=dv)))
    q, k, v, valid = gather_inputs(4, 4, 128, 128, torch.bfloat16, 71)
    worst = max(worst, gather_check(
        "edge K 8- but not 16-byte aligned (element-wise)", q,
        misaligned(k, 8), v, valid))
    for g in (1, 16):
        kk = gather_kmax(g, 128)
        worst = max(worst, gather_check(
            f"edge largest K the wrapper admits at G={g} d=128: K={kk} bf16",
            *gather_inputs(3, g, 128, kk, torch.bfloat16, 80 + g)))
        try:
            gather_mod.gather_attention(*gather_inputs(
                3, g, 128, kk + 1, torch.bfloat16, 80 + g))
        except ValueError as e:
            print(f"  K={kk + 1} at G={g} refused before a launch: {e}")
        else:
            raise AssertionError(f"K={kk + 1} at G={g} launched")
    return worst, gather_times()


def gather_times():
    """gather_attention timed at the three COMPOSED_SHAPES (K = 128, bf16,
    every slot valid) with inputs in L2 and with L2 cold, beside the plain
    version, the bound and SDPA. Like `approx_times`, it also times another
    checkout's kernel when run from that checkout's root."""
    timings = {"extra:gather_attention": {}}
    for si, (model, bh, g, d, _) in enumerate(COMPOSED_SHAPES):
        def make(seed):
            return gather_inputs(bh, g, d, 128, torch.bfloat16, seed,
                                 frac=1.0)
        first = make(39 + 100 * si)
        nbytes = sum(t.numel() * t.element_size() for t in first)
        n_sets = max(COLD_SETS, math.ceil(2 * L2_BYTES / nbytes))
        sets = [first] + [make(39 + 100 * si + i) for i in range(1, n_sets)]
        fn = gather_mod.gather_attention
        warm = cuda_ms(lambda: fn(*first))
        cold = cold_ms(fn, sets)
        plain = cuda_ms(lambda: ref.gather_attention_ref(*first))
        q, k, v, valid = first
        # the G query rows of a kv-head as SDPA's query sequence
        qb, mask = q.to(torch.bfloat16), (valid != 0)[:, None, :]
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qb, k, v, attn_mask=mask))
        t, by, nb = gather_bound(*first)
        res = {"ms": warm, "ms_l2_cold": cold, "plain_ms": plain,
               "bound_ms": t, "bound_by": by, "library_ms": lib}
        line = (f"kernel {warm:.4f} ms with its inputs in L2, {cold:.4f} ms "
                f"with L2 cold ({n_sets} input sets in turn)")
        print(f"  time gather_attention {model} (BH={bh} G={g} d={d} K=128 "
              f"bf16): {line}; plain {plain:.4f} ms, bound {t:.4f} ms ({by}:"
              f" {nb} B); library call F.scaled_dot_product_attention (bf16 "
              f"q, boolean mask) {lib:.4f} ms")
        if si == 0:
            timings["gather_attention"] = (warm, plain, t, by, lib)
            timings["extra:gather_attention"]["ms_l2_cold"] = cold
        else:
            timings["extra:gather_attention"][model] = res
    return timings


# the served prompt pass: 4 lanes x 32 heads, N = 2048, d = 128, bf16, the
# served prompts' lengths
def prompt_inputs(b, hq, hk, n, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype)
            for h in (hq, hk, hk)]


def pad_cols_zero(acc, lengths):
    """acc [B, H, N] is exactly 0 at every column at or past its length."""
    cols = torch.arange(acc.shape[-1], device=acc.device)
    pad = (cols[None, :] >= lengths[:, None].long())[:, None, :]
    return not acc.masked_select(pad.expand_as(acc)).any()


def acc_errors(acc, want):
    """(max relative error where want != 0, whether acc is 0 exactly where
    want is)."""
    nz = want != 0
    d = (acc - want).abs()
    return (float((d[nz] / want[nz].abs()).max()),
            bool(torch.equal(acc[~nz], want[~nz])))


def check_model_contract(name, b, hq, hk, n, d, dtype, lengths, obs=0,
                         row0=0, c=None, seed=0):
    """ops.prefill_attention (the model's contract) against its plain
    version → (max abs error of out, max relative error of acc)."""
    c = n - row0 if c is None else c
    q, k, v = prompt_inputs(b, hq, hk, n, d, dtype, seed)
    q_c = q[:, :, row0:row0 + c]
    ln = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    acc = torch.zeros((b, hk, n), device="cuda")
    out, acc = ops.prefill_attention(q_c, k, v, acc, row0=row0, length=ln,
                                     obs_window=obs)
    want, want_acc = ref.prefill_attention_ref(q_c, k, v, row0=row0,
                                               length=ln, obs_window=obs)
    torch.cuda.synchronize()
    acc_tol = FLIP_ACC_RTOL if v.dtype == torch.bfloat16 else FLASH_ACC_RTOL
    d_out = (out - want).abs()
    e_out = float(d_out.max())
    e_rel, zeros = acc_errors(acc, want_acc)
    over = int(((acc - want_acc).abs() > FLASH_ACC_RTOL * want_acc.abs()
                ).sum())
    pads = pad_cols_zero(acc, ln)
    print(f"  model contract {name} B={b} Hq={hq} Hk={hk} N={n} d={d} "
          f"rows [{row0}, {row0 + c}) obs={obs} {str(dtype)[6:]}: "
          f"max|dout|={e_out:.3g} (atol {FLASH_OUT_ATOL}; "
          f"{int((d_out > FLASH_OUT_ATOL).sum())} of {out.numel()} outputs "
          f"past it), acc max rel {e_rel:.3g} (rtol {acc_tol:.3g}; {over} of "
          f"{acc.numel()} entries past rtol {FLASH_ACC_RTOL}), pad columns "
          f"exactly 0 {pads}")
    assert torch.isfinite(out).all() and torch.isfinite(acc).all(), name
    assert e_out <= FLASH_OUT_ATOL and e_rel <= acc_tol, (name, e_out, e_rel)
    assert zeros and pads, name
    return e_out, e_rel


def check_tpu_contract(name, bh, g, n, d, dtype, lengths, seed):
    """ops.flash_prefill (the TPU contract: f32 probabilities, per-q-head
    acc, out in q's dtype) against its plain version; asserts, and reports
    nothing to the kernels line, which carries the main path's contract."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((rows, n, d), generator=gen, device="cuda").to(
        dtype) for rows in (bh, bh // g, bh // g))
    ln = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    out, acc = ops.flash_prefill(q, k, v, group=g, lengths=ln)
    want, want_acc = ref.flash_prefill_ref(q, k, v, group=g, lengths=ln)
    torch.cuda.synchronize()
    # a bf16 out is rounded on both sides: one bf16 ulp (2^-7 relative)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    d_out = (out.float() - want.float()).abs()
    ok_out = bool((d_out <= FLASH_OUT_ATOL + rtol * want.float().abs()).all())
    e_rel, zeros = acc_errors(acc, want_acc)
    pads = pad_cols_zero(acc[:, None, :], ln)
    print(f"  TPU contract {name} BH={bh} G={g} N={n} d={d} {str(dtype)[6:]}:"
          f" max|dout|={float(d_out.max()):.3g} (atol {FLASH_OUT_ATOL} + "
          f"rtol {rtol:.3g}) ok {ok_out}, acc max rel {e_rel:.3g} (rtol "
          f"{FLASH_ACC_RTOL}), pad columns exactly 0 {pads}")
    assert ok_out and e_rel <= FLASH_ACC_RTOL and zeros and pads, name


def flash_bound(lengths, heads, d, kv_bytes, dv=None, kv_heads=None):
    """(bound_ms, bound_by, flops, bytes) of one model-contract call over a
    whole prompt, counting only what its output needs: the rows below each
    lane's length (rows past it are outputs the contract discards), and
    two causal products over each q-head's L (L + 1) / 2 live (row, column)
    pairs (q.k over d and p.v over dv: out and the column sums both come
    from them) at the peak of the inputs' type (bf16: the tensor cores;
    f32: the CUDA cores, since the tensor cores would round f32 to TF32);
    those rows of q and of the `kv_heads` K/V heads (default: one per
    q-head) read once, of the f32 out written, acc's L columns read and
    written, one length per lane. With dv < d and one kv head, V is a view
    of K's first dv columns (MLA's latent): its bytes are K's, read once."""
    dv = d if dv is None else dv
    kv_heads = heads if kv_heads is None else kv_heads
    ln = np.asarray(lengths, dtype=np.float64)
    flops = heads * float((2 * (d + dv) * ln * (ln + 1) / 2).sum())
    kv_row = d if dv < d else d + dv
    nbytes = (int(ln.sum()) * (heads * (d * kv_bytes + dv * 4)
                               + kv_heads * (kv_row * kv_bytes + 2 * 4))
              + 4 * len(ln))
    if kv_bytes == 4:
        t, by = bound(nbytes, f32_flops=flops)
    else:
        t, by = bound(nbytes, bf16_flops=flops)
    return t, by, flops, nbytes


def check_division(blocks=65536, per_thread=64, seed=1):
    """The bf16 route divides without the operator's per-element branch
    (div_fast); check it equals the operator bit for bit on 2^30 operand
    pairs drawn over the range the kernel gives it."""
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_div_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    build.check_launch("flash_prefill_div_check", fn(
        bad.data_ptr(), blocks, per_thread, seed,
        torch.cuda.current_stream().cuda_stream))
    n, n_bad = blocks * 256 * per_thread, int(bad)
    print(f"  division without its branch (div_fast) vs the operator: "
          f"{n_bad} of {n} quotients differ (a in [2^-64, 1], b in [1, 2^32))")
    assert n_bad == 0


def f32_route_rounded(q, k, v, ln):
    """The f32 route (CUDA cores, the design PR 13 served bf16 prompts with:
    each logit an f32 FMA chain over d) on f32 copies of bf16 q, k, v, with
    the model contract's bf16-rounded probabilities → out [B, Hq, N, d].
    A direct launch: the wrapper rounds p only for bf16 V."""
    b, hq, n, d = q.shape
    bh = b * hq
    qf, kf, vf = (x.float().reshape(bh, n, d) for x in (q, k, v))
    lens = torch.repeat_interleave(ln, hq)
    out = torch.empty((bh, n, d), device="cuda")
    part = torch.empty((bh, -(-n // 64), n), device="cuda")
    acc = torch.zeros((bh, n), device="cuda")
    lib = flash_mod._bind(build.load("flash_prefill"))
    build.check_launch("flash_prefill", lib.flash_prefill_launch(
        0, 0, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), acc.data_ptr(), bh, n, n, d, d, d,
        1, 1, 0, 0, 1, ctypes.c_float(1.0 / math.sqrt(d)), ctypes.c_float(0.0),
        ctypes.c_float(0.0), torch.cuda.current_stream().cuda_stream))
    return out.reshape(b, hq, n, d)


def exact_rows(q, k, scale):
    """The rows whose largest probability lies above 1/EXACT_BELOW (those
    with l < EXACT_BELOW, which take exact logits) of causal attention of
    q [B, H, N, d] over k [B, Hk, N, d] (Hk = H, or 1 for MLA's latent; q
    cast to k's dtype first, as the kernel takes it) → (exact rows, all
    rows). Every row counts, those at or past a length too: the kernel
    computes them all. Logits in f32, 16 heads at a time."""
    b, h, n, _ = q.shape
    causal = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    count = 0
    for bi in range(b):
        kt = k[bi].float().transpose(-1, -2)
        for h0 in range(0, h, 16):
            s = torch.matmul(q[bi, h0:h0 + 16].to(k.dtype).float(),
                             kt if kt.shape[0] == 1 else kt[h0:h0 + 16])
            p_max = torch.softmax((s * scale).masked_fill(
                ~causal, ref.NEG_INF), -1).amax(-1)
            count += int((p_max > 1.0 / flash_mod.EXACT_BELOW).sum())
            del s, p_max
    return count, b * h * n


def with_exact_below(value, fn, name="EXACT_BELOW"):
    """fn() with flash_mod.EXACT_BELOW (0: no exact rows, every logit from
    the tensor cores), or the `name` given (EXACT_P), set to `value`,
    restored after."""
    kept = getattr(flash_mod, name)
    setattr(flash_mod, name, value)
    try:
        return fn()
    finally:
        setattr(flash_mod, name, kept)


def exact_rows_survey(seeds=range(12)):
    """The model contract's out error at the served prompt shape over
    `seeds`: the bf16 route as served (exact rows below EXACT_BELOW), the
    same with no exact rows (tensor-core logits alone), and the f32 route
    with rounded probabilities. Printed, not asserted (the check above
    holds the served route at its seed); also the share of exact rows."""
    ln = torch.as_tensor(LENS, dtype=torch.int32, device="cuda")
    past = {"served": 0, "tensor-core logits only": 0, "f32 route": 0}
    for seed in seeds:
        q, k, v = prompt_inputs(4, 32, 32, 2048, 128, torch.bfloat16, seed)
        want, _ = ref.prefill_attention_ref(q, k, v, length=ln)
        outs = {"served": ops.prefill_attention(q, k, v, length=ln)[0]}
        outs["tensor-core logits only"] = with_exact_below(
            0.0, lambda: ops.prefill_attention(q, k, v, length=ln)[0])
        outs["f32 route"] = f32_route_rounded(q, k, v, ln)
        line = []
        for key, out in outs.items():
            d_out = (out - want).abs()
            n_past = int((d_out > FLASH_OUT_ATOL).sum())
            past[key] += n_past > 0
            line.append(f"{key} {float(d_out.max()):.3g} ({n_past} past)")
        print(f"  seed {seed}, model contract max|dout|: " + ", ".join(line))
        if seed == SERVED_SEED:
            n_exact, _ = exact_rows(q, k, 1.0 / math.sqrt(128))
    print(f"  seeds with an output past {FLASH_OUT_ATOL}, of {len(seeds)}: "
          + ", ".join(f"{k} {v}" for k, v in past.items()) + f"; exact rows "
          f"at seed {SERVED_SEED}: {n_exact} of {4 * 32 * 2048}")
    return {"survey_seeds": len(seeds),
            "survey_seeds_past_atol": past,
            "exact_rows": n_exact}


# MLA's absorbed prompt pass (deepseek-v3): 128 q-heads over one latent of
# d = 576, V its first 512 columns (a view), scale 1/sqrt(qk_nope + rope)
LATENT_HEADS = 128
LATENT_SCALE = 1.0 / math.sqrt(192)
LATENT_LENS = (2048, 1377)


def latent_inputs(b, n, seed):
    """q [B, 128, N, 576] and the latent u [B, 1, N, 576] bf16, and v, the
    view of u's first 512 columns."""
    d, dv = flash_mod.LATENT
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, LATENT_HEADS, n, d), generator=gen,
                    device="cuda").to(torch.bfloat16)
    u = torch.randn((b, 1, n, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    return q, u, u[..., :dv]


def latent_route_ms(q, u, v, ln, obs=0):
    """(as served, with EXACT_BELOW = 0) card times of one latent-route
    call (the kernel pair through its wrapper) on q [B, 128, N, 576] bf16,
    u [B, 1, N, 576], v its view, lengths ln [B], obs_window `obs`."""
    b, h, n, d = q.shape
    qf, kf, vf = q.reshape(b * h, n, d), u.reshape(b, n, d), \
        v.reshape(b, n, v.shape[-1])
    lrep = torch.repeat_interleave(ln, h)
    acc = torch.zeros((b, n), device="cuda")

    def call():
        flash_mod.flash_prefill(qf, kf, vf, lrep, acc, group=h, acc_group=h,
                                obs_window=obs, scale=LATENT_SCALE)

    return long_ms(call), with_exact_below(0.0, lambda: long_ms(call))


def check_latent(obs, seed):
    """ops.prefill_attention at the latent shape (B = 2, N = 2048, lengths
    LATENT_LENS) against its plain version on the card, whose softmax
    denominators are the f32 rounding of the exact sums as the route's
    exact rows make them (`den_f64`): out within FLASH_OUT_ATOL of
    max|v|, acc within FLIP_ACC_RTOL, no mass past a length, v read as
    the view (no copy). Held as served (sweep 2 makes an exact row's
    logits exactly where p may reach EXACT_P) and with EXACT_P = 0 (all of
    them exactly, the tc route's rule), both printed → the served (max abs
    error of out, max relative error of acc)."""
    n = 2048
    q, u, v = latent_inputs(len(LATENT_LENS), n, seed)
    assert not v.is_contiguous()
    ln = torch.as_tensor(LATENT_LENS, dtype=torch.int32, device="cuda")
    want, want_acc = ref.prefill_attention_ref(q, u, v, length=ln,
                                               obs_window=obs,
                                               scale=LATENT_SCALE,
                                               den_f64=True)
    vmax = float(v.abs().max())
    errs = {}
    for p_min in (flash_mod.EXACT_P, 0.0):
        out, acc = with_exact_below(p_min, lambda: ops.prefill_attention(
            q, u, v, length=ln, obs_window=obs, scale=LATENT_SCALE),
            name="EXACT_P")
        torch.cuda.synchronize()
        d_out = (out - want).abs()
        e_out = float(d_out.max())
        e_rel, zeros = acc_errors(acc, want_acc)
        pads = pad_cols_zero(acc, ln)
        print(f"  latent route B=2 Hq={LATENT_HEADS} over one latent, N={n}, "
              f"d={q.shape[-1]}, dv={v.shape[-1]} (v a view), lengths "
              f"{list(LATENT_LENS)}, obs={obs}, scale 1/sqrt(192), bf16, "
              f"exact logits where p may reach {p_min:g}: max|dout|="
              f"{e_out:.3g} (atol {FLASH_OUT_ATOL} x max|v| {vmax:.3g} = "
              f"{FLASH_OUT_ATOL * vmax:.3g}; "
              f"{int((d_out > FLASH_OUT_ATOL).sum())} of {out.numel()} "
              f"outputs past {FLASH_OUT_ATOL}), acc max rel {e_rel:.3g} "
              f"(rtol {FLIP_ACC_RTOL:.3g}), pad columns exactly 0 {pads}")
        assert torch.isfinite(out).all() and torch.isfinite(acc).all()
        assert out.shape == want.shape == (2, LATENT_HEADS, n, v.shape[-1])
        assert e_out <= FLASH_OUT_ATOL * vmax and e_rel <= FLIP_ACC_RTOL, \
            (p_min, e_out, e_rel)
        assert zeros and pads
        errs[p_min] = (e_out, e_rel)
        del out, acc
    return errs[flash_mod.EXACT_P]


def latent_times():
    """The latent route's times at B = 2 (LATENT_LENS) and at phase 10's
    served prompt pass (B = 4, the served lengths), as served and with
    EXACT_BELOW = 0 (tensor-core logits alone), beside the bound, the plain
    version and F.scaled_dot_product_attention (is_causal, bf16, dv = 512,
    K and V expanded over the 128 heads, out only: no column sums) on the
    same inputs, and the exact rows of those inputs. Returns the served
    shape's numbers."""
    d, dv = flash_mod.LATENT
    n = 2048
    rows = {}
    for b, lens in ((2, LATENT_LENS), (LANES, LENS)):
        q, u, v = latent_inputs(b, n, 9 + b)
        ln = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
        ms, ms_tc = latent_route_ms(q, u, v, ln)
        plain = long_ms(lambda: ref.prefill_attention_ref(
            q, u, v, length=ln, scale=LATENT_SCALE, den_f64=True))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, u.expand(b, LATENT_HEADS, n, d),
            v.expand(b, LATENT_HEADS, n, dv), is_causal=True,
            scale=LATENT_SCALE), iters=5, warmup=1)
        n_exact, n_rows = exact_rows(q, u, LATENT_SCALE)
        t, by, flops, nbytes = flash_bound(lens, LATENT_HEADS, d, 2, dv=dv,
                                           kv_heads=1)
        t_all, _, flops_all, _ = flash_bound([n] * b, LATENT_HEADS, d, 2,
                                             dv=dv, kv_heads=1)
        # this design's tensor-core work: q.k over d in both sweeps and p.v
        # once, over all N rows of every lane
        design = b * LATENT_HEADS * n * (n + 1) / 2 * (2 * 2 * d + 2 * dv)
        print(f"  time latent route B={b} N={n} lengths {list(lens)}: kernel "
              f"pair {ms:.4f} ms, with EXACT_BELOW = 0 (tensor-core logits "
              f"alone) {ms_tc:.4f} ms, plain {plain:.4f} ms, bound {t:.4f} "
              f"ms ({by}: {flops:.4g} flop over the rows below each length, "
              f"{nbytes} B; all {b} x {n} rows: {flops_all:.4g} flop, "
              f"{t_all:.4f} ms), kernel / bound {ms / t:.1f}x, kernel / "
              f"plain {ms / plain:.3f}; F.scaled_dot_product_attention("
              f"is_causal=True, K/V expanded, out only, no column sums): "
              f"{lib:.4f} ms; exact rows (largest probability above "
              f"1/{flash_mod.EXACT_BELOW:g}) {n_exact} of {n_rows} "
              f"({n_exact / n_rows:.1%}); this design's tensor-core work "
              f"{design:.4g} flop, "
              f"{design / roofline.PEAK_FLOPS * 1e3:.4f} ms "
              f"at the bf16 peak, done at {design / ms / 1e9:.1f} TF/s as "
              f"served and {design / ms_tc / 1e9:.1f} TF/s with EXACT_BELOW "
              f"= 0")
        rows[b] = {"ms": ms, "no_exact_rows_ms": ms_tc, "plain_ms": plain,
                   "bound_ms": t, "bound_by": by, "library_ms": lib,
                   "all_rows_bound_ms": t_all, "design_flop": design,
                   "exact_rows": n_exact, "rows": n_rows}
        del q, u, v
    return {"served_B4": rows[LANES], "check_B2": rows[2]}


def flash_shape_times(model, heads, d, lengths, seed):
    """The tensor-core route at a served prompt shape (B = 4, `heads`
    heads of d over as many kv-heads, N = 2048, `lengths`, model
    contract): kernel pair, plain version, bound and
    F.scaled_dot_product_attention (is_causal, out only) on the same
    inputs."""
    q, k, v = prompt_inputs(4, heads, heads, 2048, d, torch.bfloat16, seed)
    ln = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    qf, kf, vf = (x.reshape(4 * heads, 2048, d) for x in (q, k, v))
    lens = torch.repeat_interleave(ln, heads)
    acc = torch.zeros((4 * heads, 2048), device="cuda")
    ms = cuda_ms(lambda: flash_mod.flash_prefill(qf, kf, vf, lens, acc,
                                                 group=1, acc_group=1))
    plain = cuda_ms(lambda: ref.prefill_attention_ref(q, k, v, length=ln))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    t, by, flops, nbytes = flash_bound(lengths, heads, d, 2)
    print(f"  time {model} shape (B=4 Hq=Hk={heads} N=2048 d={d} bf16, "
          f"lengths {list(lengths)}, model contract, tensor cores): kernel "
          f"pair {ms:.4f} ms, plain {plain:.4f} ms, bound {t:.4f} ms ({by}: "
          f"{flops:.4g} flop, {nbytes} B), kernel / bound {ms / t:.1f}x; "
          f"F.scaled_dot_product_attention(is_causal=True), out only: "
          f"{lib:.4f} ms")
    return {"ms": ms, "plain_ms": plain, "bound_ms": t, "bound_by": by,
            "library_ms": lib}


def phase_flash():
    check_division()
    out_err, acc_rel = 0.0, 0.0
    served = [n for n in LENS]
    gqa = [1000, 517, 999, 64]
    for args, kw in (
            (("served", 4, 32, 32, 2048, 128, torch.bfloat16, served, 0), {}),
            (("served", 4, 32, 32, 2048, 128, torch.bfloat16, served, 32), {}),
            (("granite-like GQA ragged N", 4, 32, 8, 1000, 64,
              torch.bfloat16, gqa, 0), {}),
            (("starcoder2 group 12", 4, 24, 2, 2048, 128, torch.bfloat16,
              served, 0), {}),
            (("zamba2 d=112", 4, 32, 32, 2048, 112, torch.bfloat16, served,
              0), {}),
            (("whisper d=64", 4, 8, 8, 2048, 64, torch.bfloat16,
              [PROMPT_LEN] * 4, 0), {}),
            (("f32 GQA", 2, 8, 2, 1000, 128, torch.float32, [1000, 600], 16),
             {}),
            (("served chunk", 4, 32, 32, 2048, 128, torch.bfloat16, served),
             {"row0": 1024, "c": 512, "seed": 5})):
        e_out, e_rel = check_model_contract(
            *args, **{"seed": len(args[0]), **kw})
        out_err, acc_rel = max(out_err, e_out), max(acc_rel, e_rel)
    latent_out, latent_acc = 0.0, 0.0
    for obs in (0, 32):
        e_out, e_rel = check_latent(obs, seed=20 + obs)
        latent_out, latent_acc = max(latent_out, e_out), max(latent_acc,
                                                             e_rel)
    check_tpu_contract("served", 128, 1, 2048, 128, torch.bfloat16,
                       [n for n in served for _ in range(32)], 6)
    check_tpu_contract("granite-like GQA ragged N", 128, 4, 1000, 64,
                       torch.float32, [n for n in gqa for _ in range(32)], 7)
    survey = exact_rows_survey()

    # chunked (4 x 512 rows, acc added in place) vs whole prompt, bit for bit
    q, k, v = prompt_inputs(4, 32, 32, 2048, 128, torch.bfloat16, 8)
    ln = torch.as_tensor(served, dtype=torch.int32, device="cuda")
    acc_w = torch.zeros((4, 32, 2048), device="cuda")
    out_w, _ = ops.prefill_attention(q, k, v, acc_w, row0=0, length=ln)
    acc_c = torch.zeros_like(acc_w)
    outs = [ops.prefill_attention(q[:, :, r0:r0 + 512], k, v, acc_c, row0=r0,
                                  length=ln)[0]
            for r0 in range(0, 2048, 512)]
    torch.cuda.synchronize()
    same_acc = torch.equal(acc_c, acc_w)
    same_out = torch.equal(torch.cat(outs, dim=2), out_w)
    print(f"  chunked (4 x 512 rows into one acc) vs whole prompt on the "
          f"card: column sums bit-equal {same_acc}, outputs bit-equal "
          f"{same_out}")
    assert same_acc and same_out

    # times at the served shape, the main path's contract
    qf, kf, vf = (x.reshape(128, 2048, 128) for x in (q, k, v))
    lens = torch.repeat_interleave(ln, 32)
    acc = torch.zeros((128, 2048), device="cuda")
    ms = cuda_ms(lambda: flash_mod.flash_prefill(qf, kf, vf, lens, acc,
                                                 group=1, acc_group=1))
    plain = cuda_ms(lambda: ref.prefill_attention_ref(q, k, v, length=ln))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    t, by, flops, nbytes = flash_bound(served, 32, 128, 2)
    # this design's own work: three causal products (q.k in both sweeps,
    # p.v) over all N rows of every lane
    design = 3.0 * 2 * 128 * 128 * 2048 * 2049 / 2
    print(f"  time served shape (B=4 Hq=Hk=32 N=2048 d=128 bf16, lengths "
          f"{served}, model contract, tensor cores): kernel pair {ms:.4f} "
          f"ms, plain {plain:.4f} ms, bound {t:.4f} ms ({by}: {flops:.4g} "
          f"flop, two causal products over the rows below each length, at "
          f"the 989 TF/s bf16 tensor-core peak; {nbytes} B, "
          f"{nbytes / roofline.HBM_BW * 1e3:.4f} ms at 3.35 TB/s), kernel / "
          f"bound {ms / t:.1f}x; library call F.scaled_dot_product_attention("
          f"is_causal=True), out only, no column sums: {lib:.4f} ms")
    # the same without exact rows: the tensor-core logits alone
    ms_tc = with_exact_below(0.0, lambda: cuda_ms(
        lambda: flash_mod.flash_prefill(qf, kf, vf, lens, acc, group=1,
                                        acc_group=1)))
    print(f"  time served shape, model contract, no exact rows (every logit "
          f"on the tensor cores): kernel pair {ms_tc:.4f} ms; the exact rows "
          f"(l < {flash_mod.EXACT_BELOW:g}) add {ms - ms_tc:.4f} ms")
    print(f"  this design's work, three causal products over all N rows: "
          f"{design:.4g} flop, "
          f"{design / roofline.PEAK_FLOPS * 1e3:.4f} ms at the bf16 "
          f"tensor-core peak; the kernel pair does it at "
          f"{design / ms / 1e9:.1f} TF/s")
    # the TPU contract on the same route: f32 p as hi + lo, two p.v products
    ms_tpu = cuda_ms(lambda: flash_mod.flash_prefill(
        qf, kf, vf, lens, acc, group=1, acc_group=1, model=False))
    print(f"  time served shape, TPU contract (f32 probabilities, bf16 out), "
          f"tensor cores: kernel pair {ms_tpu:.4f} ms")
    # the f32 route (CUDA cores) at the same shape, model contract
    q32, k32, v32 = (x.float() for x in (q, k, v))
    qf32, kf32, vf32 = (x.reshape(128, 2048, 128) for x in (q32, k32, v32))
    ms32 = cuda_ms(lambda: flash_mod.flash_prefill(qf32, kf32, vf32, lens,
                                                   acc, group=1, acc_group=1))
    plain32 = cuda_ms(lambda: ref.prefill_attention_ref(q32, k32, v32,
                                                        length=ln))
    lib32 = cuda_ms(lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True))
    t32, by32, _, nbytes32 = flash_bound(served, 32, 128, 4)
    print(f"  time served shape in f32, model contract, CUDA cores: kernel "
          f"pair {ms32:.4f} ms, plain {plain32:.4f} ms, bound {t32:.4f} ms "
          f"({by32}: at the 67 TF/s f32 peak; {nbytes32} B), kernel / bound "
          f"{ms32 / t32:.1f}x; F.scaled_dot_product_attention(is_causal="
          f"True) in f32, out only: {lib32:.4f} ms")
    del q32, k32, v32, qf32, kf32, vf32
    d112 = flash_shape_times("zamba2-7b", 32, 112, LENS, 12)
    d64 = flash_shape_times("whisper-base", 8, 64, (PROMPT_LEN,) * 4, 13)
    latent = latent_times()
    latent.update(max_abs_err=latent_out, acc_max_rel_err=latent_acc,
                  out_atol=f"{FLASH_OUT_ATOL} x max|v|",
                  design="d = 576, dv = 512, G = 128: one CTA per (q-head, "
                         "64-row q-block), two warpgroups, wgmma m64n16k16 "
                         "(q.k) and m64n256k16 (p.v), exact logits by a "
                         "register-tiled f32 product (sweep 2: only where p "
                         "may reach 1/32)")
    return out_err, {"bfloat16": (ms, plain, t, by, lib),
                     "extra": {"out_atol": FLASH_OUT_ATOL,
                               "acc_max_rel_err": acc_rel,
                               "acc_rtol": FLIP_ACC_RTOL,
                               "design": "bf16: tensor cores (mma.sync "
                                         "m16n8k16); f32: CUDA cores",
                               "tpu_contract_ms": ms_tpu,
                               "no_exact_rows_ms": ms_tc, **survey,
                               "f32_route_ms": ms32,
                               "f32_route_plain_ms": plain32,
                               "f32_route_bound_ms": t32,
                               "f32_route_library_ms": lib32,
                               "d112": d112, "d64": d64,
                               "latent": latent}}


# ---------------------------------------------------------------------------
# phase 4 + 5: full-width longchat-7b
# ---------------------------------------------------------------------------


def served_prune(kv, select_blocks=1, fused=True):
    """Phase 4's pruning: PROMPT_LEN // 2 heavy slots and a 64-slot
    reserve, select_k PROMPT_LEN // 16 (the phases that serve or decode
    phase 4's configuration, and the dry run's count of it, share it)."""
    return baselines.unicaim(heavy=PROMPT_LEN // 2, reserve=64,
                             select_k=PROMPT_LEN // 16,
                             select_blocks=select_blocks, fused=fused,
                             kv_dtype=kv)


def served_prompts(vocab, n=2 * LANES, new=NEW_TOKENS):
    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, vocab, LENS[i % len(LENS)]),
             new // (1 + i % 2)) for i in range(n)]


# the plain prompt-attention versions (and the attention backward's),
# watched: a call on a CUDA tensor during a serve or training run would
# mean the pass left the kernel
PLAIN_ON_CARD = {"prefill_attention_ref": 0, "flash_prefill_ref": 0,
                 "flash_prefill_bwd_ref": 0}


def watch_plain_prompt_attention():
    for name in PLAIN_ON_CARD:
        fn = getattr(ref, name)

        def watched(q, *args, _fn=fn, _name=name, **kw):
            if q.is_cuda:
                PLAIN_ON_CARD[_name] += 1
            return _fn(q, *args, **kw)
        setattr(ref, name, watched)


def phase_serve(cfg, params, kv, smi, blocks, chunk=0, n=2 * LANES,
                new=NEW_TOKENS, prune=None, lanes=LANES, prompts=None,
                kernel=None):
    """Serve the `n` requests (8 by default); every decode step must run
    one kernel per cache layer (`attn_layer_count()`: a block, or an
    application of the hybrid's shared block): ragged_decode with global
    selection, fused_decode with `blocks` > 1, and no other decode kernel;
    every prompt pass (a whole bucket or exact-length prompt, or one chunk
    with `chunk` > 0) one flash_prefill per cache layer, and no plain prompt
    attention on the card. A model with no cache (mamba2) launches no
    kernel. `prune` replaces the served unicaim pruning, `prompts` ([(token
    ids, new tokens)]) the served prompts, `kernel` the decode kernel's
    launch key. Returns (decode kernel, its launches, flash_prefill
    launches, model, handles, the loop's aggregate)."""
    if prune is None:
        prune = served_prune(kv, blocks)
    if kernel is None:
        kernel = "fused_decode" if blocks > 1 else "ragged_decode"
    if prompts is None:
        prompts = served_prompts(cfg.vocab_size, n, new)
    model = Model(cfg, prune, device="cuda")
    layers = model.attn_layer_count()
    loop = ServeLoop(model, params, lanes=lanes,
                     max_new=max(NEW_TOKENS, *(m for _, m in prompts)),
                     block=8, chunk_prefill=chunk, device="cuda")
    handles = [(loop.submit(Request(prompt=p, max_new=m)), m)
               for p, m in prompts]
    torch.cuda.synchronize()
    reset_launches()
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0
    t0 = time.monotonic()
    stats = loop.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    launches = counts.pop(kernel)
    flash = counts.pop("flash_prefill")
    c = loop.counters
    prompt_passes = c["chunk_dispatches"] if chunk else c["prefill_dispatches"]
    steps = c["decode_steps"]
    toks = sum(len(s.tokens) for s in stats)
    for s in stats:
        print(f"    req {s.rid}: lane={s.lane} prompt={s.prompt_len} "
              f"bucket={s.bucket} chunks={s.prefill_chunks} "
              f"new={len(s.tokens)} latency={s.latency:.3f}s "
              f"ttft={s.ttft:.3f}s")
    agg = loop.aggregate()
    print(f"  serve {cfg.name} policy={prune.policy} kv={kv} fused "
          f"select_blocks={blocks} chunk_prefill={chunk}: {len(stats)} "
          f"requests on {lanes} lanes, {toks} tokens in {wall:.3f}s = "
          f"{toks / wall:.1f} tok/s, p50 TTFT {agg['p50_ttft_s']:.3f}s; "
          f"{steps} decode steps, {c['prefill_dispatches']} prefills, "
          f"{c['chunk_dispatches']} chunk dispatches, "
          f"{c['grouped_requests']} requests group-admitted; {kernel} "
          f"launches {launches} = {layers} x {steps}: "
          f"{launches == layers * steps}; flash_prefill launches {flash} = "
          f"{layers} x {prompt_passes}: {flash == layers * prompt_passes}; "
          f"plain prompt attention on the card {PLAIN_ON_CARD}; other "
          f"kernels {counts}  [{smi}]")
    assert all(h.done and len(h.tokens) == m for h, m in handles)
    assert c["nonfinite_lanes"] == 0
    assert launches == layers * steps and (launches > 0) == (layers > 0)
    assert flash == layers * prompt_passes and (flash > 0) == (layers > 0)
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    assert not any(counts.values()), counts
    if chunk:
        want = sum(math.ceil(len(p) / chunk) for p, _ in prompts)
        assert c["chunk_dispatches"] == want, (c["chunk_dispatches"], want)
    return kernel, launches, flash, model, [h for h, _ in handles], agg


def served_batch(cfg):
    """The 4 served prompts padded to the 2048 bucket, with their lengths."""
    prompts = served_prompts(cfg.vocab_size)[:LANES]
    padded = np.zeros((LANES, PROMPT_LEN), np.int64)
    for i, (p, _) in enumerate(prompts):
        padded[i, :len(p)] = p
    return {"tokens": torch.as_tensor(padded, device="cuda"),
            "length": torch.as_tensor([len(p) for p, _ in prompts],
                                      device="cuda")}


def phase_teacher(cfg, params, model, steps=16, batch=None, hold=True):
    """Where two greedy streams part: from one prefilled state (of `batch`,
    by default the 4 served prompts) the decode kernel's path and the
    composed plain path take the same tokens (the kernel path's greedy
    choices) for `steps` steps. Printed: the largest logit difference, how
    often the top-1 agrees (held to TEACHER_AGREE_MIN when `hold`), and
    where it does not, the composed path's own gap between its top two
    logits (a near-tie that the two paths' summation orders may settle
    either way). The floor is TEACHER_AGREE_MIN of 64 at any steps x
    lanes. Returns the agreement."""
    logits, st = model.prefill(params, batch or served_batch(cfg))
    composed = Model(cfg, dataclasses.replace(model.prune, fused=False),
                     device="cuda")
    st_c = st.clone()
    tok = torch.argmax(logits, -1)
    lanes = tok.shape[0]
    floor = math.ceil(TEACHER_AGREE_MIN * steps * lanes / 64)
    worst, agree, gaps = 0.0, 0, []
    for _ in range(steps):
        lk, st = model.decode_step(params, st, tok)
        lc, st_c = composed.decode_step(params, st_c, tok)
        worst = max(worst, float((lk - lc).abs().max()))
        ak, ac = torch.argmax(lk, -1), torch.argmax(lc, -1)
        agree += int((ak == ac).sum())
        top2 = torch.topk(lc, 2, dim=-1).values
        gaps += [round(float(x), 4) for x in (top2[:, 0] - top2[:, 1])[
            ak != ac]]
        tok = ak
    print(f"  teacher-forced {cfg.name} kv={model.prune.kv_dtype} "
          f"select_blocks={model.prune.select_blocks}, decode kernel vs "
          f"composed path: {steps} steps x {lanes} lanes, the same tokens "
          f"into both paths: logits max|d| {worst:.3g}, top-1 equal in "
          f"{agree} of {steps * lanes}"
          f"{f' (floor {floor})' if hold else ' (printed, not held)'}; the "
          f"composed path's top-2 gap where they differ: {sorted(gaps)}")
    assert math.isfinite(worst)
    assert agree >= floor or not hold, (agree, floor)
    return agree


def phase_chunked(cfg, params, model, whole, chunked, chunk, n=2 * LANES):
    """Chunked vs whole admission of the same requests (the chunked loop's
    `n`, a prefix of the whole loop's, its streams as long or shorter):
    equal streams are counted (cuBLAS may pick other GEMM kernels for
    512-row and longer products, so they are not asserted); per request,
    a whole-bucket prefill and a chunked one of its prompt must keep the
    same layer-0 positions on at least KEPT_MIN of the slots and give
    first-token logits within PATH_ATOL."""
    same = sum(a.tokens[:len(b.tokens)] == b.tokens
               for a, b in zip(whole, chunked))
    worst_kept, worst_logit = 1.0, 0.0
    for p, _ in served_prompts(cfg.vocab_size, n):
        t = len(p)
        bucket = bucket_length(t)
        padded = np.zeros(bucket, np.int64)
        padded[:t] = p
        length = torch.as_tensor([t], device="cuda")
        lw, sw = model.prefill_one(params, torch.as_tensor(padded), t)
        ps = model.init_prefill_chunk_state(1, bucket)
        n = math.ceil(t / chunk)
        for ci in range(n):
            x, ps = model.prefill_chunk(
                params, ps, torch.as_tensor(padded[None, ci * chunk:
                                                   (ci + 1) * chunk],
                                            device="cuda"),
                ci * chunk, length)
        lc, sc = model.prefill_finalize(params, ps, x, (n - 1) * chunk,
                                        length)
        pw, pc = sw.kv.pos[0, 0], sc.kv.pos[0, 0]          # [Hk, S]
        hits = sum(int(torch.isin(pw[h][pw[h] >= 0], pc[h][pc[h] >= 0]).sum())
                   for h in range(pw.shape[0]))
        agree = hits / int((pw >= 0).sum())
        worst_kept = min(worst_kept, agree)
        worst_logit = max(worst_logit, float((lc - lw[None]).abs().max()))
    print(f"  chunked (chunk_prefill={chunk}) vs whole admission: "
          f"{same} of {len(chunked)} streams equal; per request, layer-0 kept "
          f"positions agree on >= {worst_kept:.4%} of slots (need "
          f"{KEPT_MIN:.0%}), first-token logits max|d| {worst_logit:.3g} "
          f"(atol {PATH_ATOL})")
    assert worst_kept >= KEPT_MIN and worst_logit <= PATH_ATOL


# phase 6: a shared system prompt P; A-D = P + 512 new tokens, E = A and
# F = B (exact repeats), G = P[:1024] + 500 new tokens, H unrelated
PREFIX_SHARED, PREFIX_G_HEAD, PREFIX_G_NEW, PREFIX_H = 1536, 1024, 500, 682
PREFIX_BUDGET = 16 << 30           # holds every entry of the trace (~11 GB)


def prefix_trace(vocab, new=NEW_TOKENS):
    """(prompt, max_new, prompt tokens a warm loop should reuse, exact):
    `new` tokens for A, C, E and G, half of them for the others."""
    rng = np.random.default_rng(SEED)
    p = rng.integers(0, vocab, PREFIX_SHARED)
    a, b, c, d = (np.concatenate([p, rng.integers(
        0, vocab, PROMPT_LEN - PREFIX_SHARED)]) for _ in range(4))
    g = np.concatenate([p[:PREFIX_G_HEAD],
                        rng.integers(0, vocab, PREFIX_G_NEW)])
    h = rng.integers(0, vocab, PREFIX_H)
    # H (the shortest bucket) is admitted first, then A; B-D resume from
    # A's rows at the deepest chunk boundary inside both prompts, G at
    # 1,024; E and F splice A's and B's finalized states
    reuse = [(0, False), (PREFIX_SHARED, False), (PREFIX_SHARED, False),
             (PREFIX_SHARED, False), (PROMPT_LEN, True), (PROMPT_LEN, True),
             (PREFIX_G_HEAD, False), (0, False)]
    return [(x, new // (1 + i % 2), *reuse[i])
            for i, x in enumerate((a, b, c, d, a, b, g, h))]


def run_prefix_loop(model, params, trace, budget):
    loop = ServeLoop(model, params, lanes=LANES, max_new=NEW_TOKENS,
                     block=8, chunk_prefill=CHUNK, prefix_cache_bytes=budget,
                     device="cuda")
    handles = [loop.submit(Request(prompt=p, max_new=m))
               for p, m, _, _ in trace]
    torch.cuda.synchronize()
    reset_launches()
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0
    t0 = time.monotonic()
    loop.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    c = loop.counters
    assert all(h.done and len(h.tokens) == m
               for h, (_, m, _, _) in zip(handles, trace))
    assert c["nonfinite_lanes"] == 0
    main_path = {"ragged_decode": counts.pop("ragged_decode"),
                 "flash_prefill": counts.pop("flash_prefill")}
    layers = model.cfg.num_layers
    assert main_path["ragged_decode"] == layers * c["decode_steps"] > 0, c
    assert main_path["flash_prefill"] == layers * c["chunk_dispatches"] > 0
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    assert not any(counts.values()), counts
    return loop, handles, wall, main_path


def phase_prefix(cfg, params, kv, smi, new=NEW_TOKENS):
    """The prefix cache at full width: cold and warm loops of one
    configuration over the shared-prefix trace, `new` tokens for its
    longest requests. Returns the warm and cold loops' ragged_decode and
    flash_prefill launches."""
    prune = served_prune(kv)
    model = Model(cfg, prune, device="cuda")
    trace = prefix_trace(cfg.vocab_size, new)
    launches = {"ragged_decode": 0, "flash_prefill": 0}
    runs = {}
    for name, budget in (("cold", 0), ("warm", PREFIX_BUDGET)):
        loop, handles, wall, counted = run_prefix_loop(model, params, trace,
                                                       budget)
        c, agg = loop.counters, loop.aggregate()
        for kernel, n in counted.items():
            launches[kernel] += n
        toks = sum(len(h.tokens) for h in handles)
        print(f"  prefix {name} kv={kv}: {len(handles)} requests, {toks} "
              f"tokens in {wall:.3f}s = {toks / wall:.1f} tok/s, p50 TTFT "
              f"{agg['p50_ttft_s']:.3f}s; {c['decode_steps']} decode steps, "
              f"{c['chunk_dispatches']} chunk + {c['prefill_dispatches']} "
              f"finalize dispatches; lookups {c['prefix_lookups']}, hits "
              f"{c['prefix_hits']} ({c['prefix_exact_hits']} exact), "
              f"{c['prefix_tokens_reused']} prompt tokens reused  [{smi}]")
        runs[name] = (loop, handles, wall)
        if name == "warm":
            pc = loop.prefix_cache
            host = loop.prefix_host_s
            print(f"  prefix warm kv={kv}: trie {pc.bytes} bytes counted in "
                  f"{pc.entries} entries (budget {PREFIX_BUDGET}), "
                  f"{pc.evictions} evictions; host time of the snapshot "
                  f"copies {host['insert_s']:.3f}s, of the "
                  f"{c['prefix_exact_hits']} exact-hit splices "
                  f"{host['splice_s']:.4f}s")
    (cold, hc, _), (warm, hw, _) = runs["cold"], runs["warm"]
    cc, wc = cold.counters, warm.counters
    print("  TTFT cold -> warm: " + ", ".join(
        f"req {a.rid} ({'exact' if exact else n}) {a.stats.ttft:.3f} -> "
        f"{b.stats.ttft:.3f}s"
        for a, b, (_, _, n, exact) in zip(hc, hw, trace) if n))
    same = [a.tokens == b.tokens for a, b in zip(hc, hw)]
    print(f"  warm vs cold streams equal: {sum(same)} of {len(same)}")
    assert all(same), same
    assert [(h.stats.prefix_tokens, h.stats.prefix_exact) for h in hw] == [
        (n, exact) for _, _, n, exact in trace]
    hits = [t for t in trace if t[2]]
    assert wc["prefix_lookups"] == len(trace)
    assert wc["prefix_hits"] == len(hits)
    assert wc["prefix_exact_hits"] == sum(t[3] for t in trace)
    assert wc["prefix_tokens_reused"] == sum(t[2] for t in trace)
    skipped = sum(math.ceil(len(p) / CHUNK) if exact else n // CHUNK
                  for p, _, n, exact in trace)
    assert wc["chunk_dispatches"] == cc["chunk_dispatches"] - skipped, (
        wc["chunk_dispatches"], cc["chunk_dispatches"], skipped)
    assert cc["chunk_dispatches"] == sum(math.ceil(len(p) / CHUNK)
                                         for p, _, _, _ in trace)
    assert wc["prefill_dispatches"] == (cc["prefill_dispatches"]
                                        - sum(t[3] for t in trace))
    assert cold.prefix_cache is None and cc["prefix_lookups"] == 0
    pc = warm.prefix_cache
    assert 0 < pc.bytes <= PREFIX_BUDGET and pc.evictions == 0, pc.stats()
    return launches


# ---------------------------------------------------------------------------
# phase 7: per-lane sampling knobs, a preemption and reservation
# ---------------------------------------------------------------------------

# six requests of about 1,024 tokens (one bucket) R0-R5, then, after one
# block, a priority-1 arrival: R2 has the most work left then and is the
# victim. R0, R1 and R5 are greedy, R2 and R3 sample with pinned seeds, R4
# is greedy with its own stop token.
PERLANE_LENS = (1024, 1000, 1017, 990, 1024, 1008)
PERLANE_NEW = (16, 12, 24, 16, 16, 12)
PERLANE_ARRIVAL = (1011, 8)        # the priority-1 request: length, budget
PERLANE_KNOBS = {2: SamplingParams(temperature=0.8, top_k=50),
                 3: SamplingParams(temperature=1.0, top_p=0.9)}
PERLANE_SEEDS = {2: 7, 3: 11}
VICTIM, STOPPED = 2, 4
SAMPLER_DRAWS = 512
COST_STEPS = 2                     # decode steps a block measured alone
# a token whose mass before it lies this close to top_p may fall on either
# side of the nucleus cut (f32 on the card against f64 here)
NUCLEUS_EDGE = 1e-6


def perlane_prompts(vocab):
    rng = np.random.default_rng(SEED + 7)
    return ([rng.integers(0, vocab, n) for n in PERLANE_LENS],
            rng.integers(0, vocab, PERLANE_ARRIVAL[0]))


def perlane_requests(prompts, sampled=True, stop=None):
    """Request fields of R0-R5. `sampled=False` is the all-greedy twin: R2
    and R3 keep their seeds and a (greedy) SamplingParams, so they are
    admitted solo as in the sampled trace and every lane frees at the same
    block. R4 stops on `stop` (None: the loop's eos, never met)."""
    reqs = [dict(prompt=p, max_new=m)
            for p, m in zip(prompts, PERLANE_NEW)]
    for i, sp in PERLANE_KNOBS.items():
        reqs[i].update(sampling=sp if sampled else SamplingParams(),
                       sample_seed=PERLANE_SEEDS[i])
    reqs[STOPPED]["sampling"] = SamplingParams(eos=stop)
    return reqs


def run_perlane_loop(model, params, reqs, arrival=None, reverse=False):
    """Submit `reqs` (reversed with `reverse`), schedule, run one block,
    submit `arrival` (priority 1) if given, and run to the end → (loop,
    handles in R order, lanes first admitted to, wall, launches)."""
    loop = ServeLoop(model, params, lanes=LANES, block=8, device="cuda")
    order = list(range(len(reqs)))[::-1] if reverse else list(
        range(len(reqs)))
    handles = {i: loop.submit(Request(**reqs[i])) for i in order}
    torch.cuda.synchronize()
    reset_launches()
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0
    t0 = time.monotonic()
    loop.schedule()
    first = {i: h.stats.lane for i, h in handles.items()}
    loop._step_block()
    if arrival is not None:
        handles[len(reqs)] = loop.submit(Request(
            prompt=arrival, max_new=PERLANE_ARRIVAL[1], priority=1))
    loop.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    c = loop.counters
    layers = model.cfg.num_layers
    main_path = {"ragged_decode": counts.pop("ragged_decode"),
                 "flash_prefill": counts.pop("flash_prefill")}
    assert all(h.done for h in handles.values())
    assert c["nonfinite_lanes"] == 0
    assert main_path["ragged_decode"] == layers * c["decode_steps"] > 0, c
    assert main_path["flash_prefill"] == layers * c["prefill_dispatches"] > 0
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    assert not any(counts.values()), counts
    return loop, [handles[i] for i in sorted(handles)], first, wall, main_path


# the aten ops a decode step of `decode_block_lanes` adds to `one_stop_block`:
# the non-finite sentinel's deactivation of a poisoned lane
SENTINEL_OPS = {"aten.bitwise_and.Tensor": 1}


def one_stop_block(model, params, state, tok, active, rem, eos, steps):
    """The decode block as the engine ran it before per-lane knobs (greedy,
    one stop token for every lane), kept to count what an all-greedy
    `decode_block_lanes` block adds to it (`SENTINEL_OPS` a step)."""
    finite = torch.ones(tok.shape[0], dtype=torch.bool, device=tok.device)
    toks, emits = [], []
    for _ in range(steps):
        logits, state = model.decode_step(params, state, tok, active)
        finite &= torch.isfinite(logits).all(dim=-1) | ~active
        emit = active & (rem > 0) & (tok != eos)
        rem = rem - emit.to(rem.dtype)
        toks.append(tok)
        emits.append(emit)
        active = emit & (rem > 0)
        tok = torch.argmax(logits, -1)
    return state, tok, active, rem, finite, torch.stack(toks), torch.stack(
        emits)


def device_events(fn):
    """(device events: kernels, copies and sets; their card ms) that `fn`
    puts on the card (torch.profiler, CUDA activity). A profile can miss
    or add a few events at its edges: `aten_ops` is the exact count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in events) / 1e3
    return sum(e.count for e in events), busy


def aten_ops(fn):
    """The aten ops `fn` dispatches, by name: each launches the same
    kernels for the same shapes, so equal ops are equal launches."""
    from collections import Counter
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Count() as mode:
        fn()
    return mode.ops


def host_syncs(fn):
    """Where `fn` synchronises the host with the card (torch's sync debug
    mode) → ["file:line", ...]."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def truncated_support(row, t, k, p):
    """[V] bool: the tokens the next-token rule may draw from one row of
    logits (f64, sorted in numpy: a plain version independent of the
    port's). Greedy: the first argmax alone. A token whose mass before it
    lies within NUCLEUS_EDGE of top_p counts as inside."""
    support = np.zeros(len(row), bool)
    if t <= 0:
        support[np.argmax(row)] = True
        return support
    sl = np.sort(row)[::-1]
    kth = sl[min(k, len(sl)) - 1] if k > 0 else -np.inf
    support = row >= kth
    if 0 < p < 1:
        q = np.exp((sl - sl[0]) / t) * (sl >= kth)
        q /= q.sum()
        keep = (np.cumsum(q) - q) < p + NUCLEUS_EDGE
        support &= row >= sl[keep].min()
    return support


def phase_perlane(cfg, params, kv, smi):
    """Per-lane knobs, a preemption and reservation at full width. Returns
    the launches of ragged_decode and flash_prefill over its four loops."""
    prune = served_prune(kv)
    model = Model(cfg, prune, device="cuda")
    layers = cfg.num_layers
    prompts, arrival = perlane_prompts(cfg.vocab_size)
    launches = {"ragged_decode": 0, "flash_prefill": 0}

    def run(name, reqs, arrival=None, reverse=False):
        loop, hs, first, wall, counted = run_perlane_loop(
            model, params, reqs, arrival, reverse)
        for k, n in counted.items():
            launches[k] += n
        c = loop.counters
        toks = sum(len(h.tokens) for h in hs)
        print(f"  perlane {name} kv={kv}: {len(hs)} requests, {toks} tokens "
              f"in {wall:.3f}s = {toks / wall:.1f} tok/s; "
              f"{c['decode_steps']} decode steps, {c['prefill_dispatches']} "
              f"prefills ({c['grouped_admissions']} grouped), preemptions "
              f"{c['preemptions']}, reservations {c['reservations']} "
              f"({c['reserved_admits']} admitted); first lanes "
              f"{[first[i] for i in sorted(first)]}; ragged_decode "
              f"{counted['ragged_decode']} = {layers} x "
              f"{c['decode_steps']}, flash_prefill "
              f"{counted['flash_prefill']} = {layers} x "
              f"{c['prefill_dispatches']}  [{smi}]")
        return loop, hs, first

    _, probe, _ = run("probe (all greedy, R4 with no stop token)",
                      perlane_requests(prompts, sampled=False), arrival)
    r4 = probe[STOPPED].tokens
    # the stop token: the first token whose first occurrence is at index
    # >= 1, so the stopped stream is not empty (index 0 if none is)
    cut = next((i for i, t in enumerate(r4) if i >= 1 and r4.index(t) == i),
               0)
    stop = r4[cut]
    _, greedy, _ = run("all-greedy twin",
                       perlane_requests(prompts, sampled=False, stop=stop),
                       arrival)
    loop, mixed, first = run("mixed knobs",
                             perlane_requests(prompts, stop=stop), arrival)
    _, rev, rfirst = run("reversed, no preemption",
                         perlane_requests(prompts, stop=stop), reverse=True)
    greedy_ids = [i for i in range(len(mixed)) if i not in PERLANE_KNOBS]
    same_greedy = [mixed[i].tokens == greedy[i].tokens for i in greedy_ids]
    same_sampled = [mixed[i].tokens == rev[i].tokens for i in PERLANE_KNOBS]
    print(f"  perlane kv={kv}: R{STOPPED} stops on token {stop} at index "
          f"{cut} (twin {len(greedy[STOPPED].tokens)}, mixed "
          f"{len(mixed[STOPPED].tokens)} tokens); greedy streams equal the "
          f"all-greedy twin's: {sum(same_greedy)} of {len(same_greedy)}; "
          f"sampled streams equal the reversed trace's: {sum(same_sampled)} "
          f"of {len(same_sampled)} (first lanes "
          f"{[first[i] for i in PERLANE_KNOBS]} vs "
          f"{[rfirst[i] for i in PERLANE_KNOBS]}), the victim R{VICTIM} "
          f"preempted {mixed[VICTIM].stats.preemptions}x; sampled vs the "
          f"twin's greedy streams differ: "
          f"{[mixed[i].tokens != greedy[i].tokens for i in PERLANE_KNOBS]}")
    assert greedy[STOPPED].tokens == r4[:cut] == mixed[STOPPED].tokens
    assert all(same_greedy), same_greedy
    assert all(same_sampled), same_sampled
    assert all(first[i] != rfirst[i] for i in PERLANE_KNOBS), (first, rfirst)
    assert loop.counters["preemptions"] == 1
    assert mixed[VICTIM].stats.preemptions == 1
    assert rev[VICTIM].stats.preemptions == 0
    assert any(mixed[i].tokens != greedy[i].tokens for i in PERLANE_KNOBS)
    perlane_costs(model, params, loop, kv, smi)
    return launches


def perlane_costs(model, params, loop, kv, smi):
    """On the mixed loop's final 4-lane state, with blocks of COST_STEPS
    steps: the aten ops of the one-stop block, an all-greedy one and a
    sampled one; their device events and card time; host syncs and host
    wall a step with and without sampled lanes; the sampler's card time
    and its draws' support; a preemption's capture and resume."""
    dev, state, tok, gens = "cuda", loop.state, loop.tok, loop._lane_gens
    steps = COST_STEPS
    active = torch.ones(LANES, dtype=torch.bool, device=dev)
    rem = torch.full((LANES,), 1 << 20, dtype=torch.int32, device=dev)
    greedy = (np.zeros(LANES, np.float32), np.zeros(LANES, np.int32),
              np.zeros(LANES, np.float32))
    # lane 0 greedy, 1 top-k, 2 top-p, 3 both
    mixed = (np.array([0.0, 0.8, 1.0, 0.8], np.float32),
             np.array([0, 50, 0, 50], np.int32),
             np.array([0.0, 0.0, 0.9, 0.9], np.float32))

    def block(knobs):
        nonlocal state, tok
        state, tok = decode_block_lanes(model, params, state, tok, active,
                                        rem, -1, gens, *knobs, steps)[:2]

    def old():
        nonlocal state, tok
        state, tok = one_stop_block(model, params, state, tok, active,
                                    rem, -1, steps)[:2]

    runs = {"one stop": old, "all greedy": lambda: block(greedy),
            "sampled": lambda: block(mixed)}
    for fn in runs.values():                           # warm
        fn()
    ops = {name: aten_ops(fn) for name, fn in runs.items()}
    events = {name: device_events(fn) for name, fn in runs.items()}
    added = ops["sampled"] - ops["all greedy"]
    new_kinds = sorted(k for k in added if k not in ops["all greedy"])
    # host wall in turns; the first turn also records host syncs
    syncs, wall = {}, {"all greedy": [], "sampled": []}
    for turn in range(2):
        for name in wall:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if turn == 0:
                syncs[name] = host_syncs(runs[name])
            else:
                runs[name]()
            torch.cuda.synchronize()
            wall[name].append(round((time.monotonic() - t0) / steps * 1e3,
                                    2))
    # the non-finite sentinel's deactivation (`active & ok`) is the one op
    # a step that an all-greedy block adds to the one-stop block
    sentinel = {op: n * steps for op, n in SENTINEL_OPS.items()}
    extra = ops["all greedy"] - ops["one stop"]
    print(f"  perlane kv={kv}: a block of {steps} steps: aten ops "
          f"{ {k: sum(v.values()) for k, v in ops.items()} } (the all-greedy "
          f"block adds to the one-stop block {dict(extra)}, the sentinel's "
          f"ops x {steps} steps: {dict(extra) == sentinel}); device events "
          f"(kernels, copies, sets) and card ms a step "
          f"{ {k: (n, round(ms / steps, 3)) for k, (n, ms) in events.items()} }"
          f"; a sampled block adds {sum(added.values())} aten ops, of new "
          f"kinds {new_kinds}; host syncs a block {syncs}; host wall ms a "
          f"step, in turns: {wall}  [{smi}]")
    assert dict(extra) == sentinel and not ops["one stop"] - ops[
        "all greedy"], (extra, ops["one stop"] - ops["all greedy"])
    assert set(syncs["sampled"]) <= set(syncs["all greedy"]), syncs

    logits, state = model.decode_step(params, state, tok, active)
    v = logits.shape[-1]
    t, k, p = (torch.as_tensor(x, device=dev) for x in mixed)
    noise = gumbel_noise(gens, v, dev)
    noise_ms = cuda_ms(lambda: gumbel_noise(gens, v, dev))
    rule_ms = cuda_ms(lambda: _next_token_lanes(logits, noise, t, k, p))
    step_ms = cuda_ms(lambda: _next_token_lanes(
        logits, gumbel_noise(gens, v, dev), t, k, p))
    argmax_ms = cuda_ms(lambda: torch.argmax(logits, -1))
    step_syncs = host_syncs(lambda: _next_token_lanes(
        logits, gumbel_noise(gens, v, dev), t, k, p))
    draws = torch.stack([_next_token_lanes(
        logits, gumbel_noise(gens, v, dev), t, k, p)
        for _ in range(SAMPLER_DRAWS)]).cpu().numpy()     # [draws, lanes]
    rows = logits.double().cpu().numpy()
    sizes, drawn = [], []
    for lane in range(LANES):
        support = truncated_support(rows[lane], *(x[lane] for x in mixed))
        sizes.append(int(support.sum()))
        drawn.append(len(set(draws[:, lane].tolist())))
        assert support[draws[:, lane]].all(), lane
    assert not step_syncs, step_syncs
    print(f"  perlane kv={kv} sampler at [{LANES}, {v}] (lane 0 greedy, 1 "
          f"top-k 50, 2 top-p 0.9, 3 both): a sampled step {step_ms:.4f} ms "
          f"of card time (noise {noise_ms:.4f}, rule {rule_ms:.4f}; the "
          f"greedy step's argmax {argmax_ms:.4f}), host syncs a sampled step "
          f"{step_syncs}; {SAMPLER_DRAWS} draws "
          f"inside the truncated support on every lane: support sizes "
          f"{sizes}, distinct tokens drawn {drawn}  [{smi}]")

    fresh = state_lane_slice(state, 0)
    nbytes = sum(getattr(fresh.kv, f).numel()
                 * getattr(fresh.kv, f).element_size()
                 for f in FIELDS if getattr(fresh.kv, f) is not None)
    capture, resume = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fresh = state_lane_slice(state, 0)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        state_lane_insert(state, 1, fresh)
        torch.cuda.synchronize()
        capture.append(t1 - t0)
        resume.append(time.monotonic() - t1)
    cap, res = float(np.median(capture)), float(np.median(resume))
    print(f"  perlane kv={kv} preemption: one lane's state {nbytes / 1e9:.4f}"
          f" GB; capture (state_lane_slice, read + write) {cap * 1e3:.3f} ms "
          f"= {2 * nbytes / cap / 1e9:.0f} GB/s, resume (state_lane_insert) "
          f"{res * 1e3:.3f} ms = {2 * nbytes / res / 1e9:.0f} GB/s; median "
          f"of 5, host wall with sync  [{smi}]")


# ---------------------------------------------------------------------------
# phase 8: fault tolerance — quarantine and retry, exhausted retries, inert
# chaos, a deadline under a stall, cancellation, backpressure, the ladder
# ---------------------------------------------------------------------------

# six requests of about 1,024 tokens (one bucket), 16 new tokens each (two
# blocks of 8): R0, R2, R4, R5 greedy, R1 top-k and R3 top-p with pinned
# seeds (each admitted solo). R0-R3 fill the 4 lanes; R4 and R5 wait.
FAULT_LENS = (1024, 1000, 1017, 990, 1008, 1020)
FAULT_NEW = 16
FAULT_KNOBS = {1: SamplingParams(temperature=0.8, top_k=50),
               3: SamplingParams(temperature=1.0, top_p=0.9)}
FAULT_SEEDS = {1: 7, 3: 11}
# NaN logits on lanes 0 and 1 (R0 greedy, R1 sampled) at every step of the
# second block: both are quarantined and retried on other lanes
QUARANTINE = ChaosConfig(seed=3, logit_fault_rate=1.0, fault_blocks=(1,),
                         fault_lanes=(0, 1))
FAIL_STEP = 3        # exhausted retries: lane 0's first NaN, block 1
# a stall before block 1 as long as the deadline: the deadline passes
# inside the stall whenever the request's prefill and block 0 end before
# it (1.27-1.55 s on an H100 at 700 W, 130-150 ms a host-bound step). The
# host sets that time, so the deadline is at least the clean loop's wall
# in the same run (two more blocks and three more prefills than the
# deadline loop runs before its stall)
STALL_S = DEADLINE_S = 3.0
FLOOD_QUEUE = 4       # the flood: 3 x FLOOD_QUEUE requests in two waves
LADDER = ({"block": 4},)


def fault_requests(vocab):
    """Request fields of R0-R5."""
    rng = np.random.default_rng(SEED + 8)
    reqs = [dict(prompt=rng.integers(0, vocab, t), max_new=FAULT_NEW)
            for t in FAULT_LENS]
    for i, sp in FAULT_KNOBS.items():
        reqs[i].update(sampling=sp, sample_seed=FAULT_SEEDS[i])
    return reqs


def fail_chaos():
    """NaN logits on lane 0 of block 1 from step FAIL_STEP on: the first
    seed whose mask (rate 0.5) starts there."""
    for seed in itertools.count():
        c = ChaosConfig(seed=seed, logit_fault_rate=0.5, fault_blocks=(1,),
                        fault_lanes=(0,))
        col = c.fault_mask(1, 8, LANES)[:, 0]
        if col.any() and int(np.argmax(col)) == FAIL_STEP:
            return c


def check_main_path(loop, main_path, others):
    """Every prompt pass of the loop (re-prefills of retried requests
    included) ran flash_prefill once a layer, every decode step
    ragged_decode once a layer, and nothing else ran a kernel or the plain
    prompt attention on the card."""
    layers, c = loop.model.cfg.num_layers, loop.counters
    assert main_path["ragged_decode"] == layers * c["decode_steps"] > 0, c
    assert main_path["flash_prefill"] == layers * c["prefill_dispatches"] > 0
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    assert not any(others.values()), others


def run_fault_loop(model, params, reqs, drive=None, **kw):
    """Serve `reqs` on LANES lanes, block 8 (`drive(loop, handles)` in place
    of `run()`) → (loop, handles, wall, launches of the main path)."""
    loop = ServeLoop(model, params, lanes=LANES, block=8,
                     device=model.device, **kw)
    hs = [loop.submit(Request(**r)) for r in reqs]
    torch.cuda.synchronize()
    reset_launches()
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0
    t0 = time.monotonic()
    if drive is None:
        loop.run()
    else:
        drive(loop, hs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    main_path = {"ragged_decode": counts.pop("ragged_decode"),
                 "flash_prefill": counts.pop("flash_prefill")}
    check_main_path(loop, main_path, counts)
    return loop, hs, wall, main_path


FAULT_COUNTERS = ("prefill_dispatches", "decode_blocks", "decode_steps",
                  "nonfinite_lanes", "quarantined_lanes", "retried_requests",
                  "failed_requests", "deadline_expired", "cancelled_requests",
                  "rejected_requests", "shed_requests", "degrade_down",
                  "degrade_up", "chaos_faults", "chaos_stalls")


def fault_summary(name, kv, loop, hs, wall, launches, smi):
    c = loop.counters
    print(f"  faults {name} kv={kv}: wall {wall:.3f}s; outcomes "
          f"{[h.outcome for h in hs]}, tokens {[len(h.tokens) for h in hs]}, "
          f"retries {[h.stats.retries for h in hs]}; "
          f"{ {k: c[k] for k in FAULT_COUNTERS if c[k]} }; ragged_decode "
          f"{launches['ragged_decode']} = 32 x {c['decode_steps']}, "
          f"flash_prefill {launches['flash_prefill']} = 32 x "
          f"{c['prefill_dispatches']}  [{smi}]")


def phase_faults(cfg, params, smi):
    """Fault tolerance at full width: retried streams equal the clean
    run's (greedy and seeded sampled, bf16 and int8), every loop's
    launches are the main path's, and each loop's counters are the ones
    the scheduler gives its trace. Returns the launches of ragged_decode
    and flash_prefill."""
    launches = {"ragged_decode": 0, "flash_prefill": 0}

    def run(name, kv, model, reqs, drive=None, **kw):
        loop, hs, wall, counted = run_fault_loop(model, params, reqs, drive,
                                                 **kw)
        for k, n in counted.items():
            launches[k] += n
        fault_summary(name, kv, loop, hs, wall, counted, smi)
        return loop, hs, wall

    reqs = fault_requests(cfg.vocab_size)
    for kv in ("bf16", "int8"):
        model = Model(cfg, served_prune(kv), device="cuda")
        clean, c_hs, c_wall = run("clean", kv, model, reqs)
        quar, q_hs, q_wall = run("quarantine", kv, model, reqs,
                                 chaos=QUARANTINE)
        want = [h.tokens for h in c_hs]
        same = sum(h.tokens == w for h, w in zip(q_hs, want))
        assert [h.outcome for h in q_hs] == ["done"] * len(reqs)
        assert [h.stats.retries for h in q_hs] == [1, 1, 0, 0, 0, 0]
        qc, cc = quar.counters, clean.counters
        assert (qc["quarantined_lanes"], qc["retried_requests"],
                qc["nonfinite_lanes"], qc["chaos_faults"]) == (2, 2, 2, 16), qc
        assert qc["prefill_dispatches"] == cc["prefill_dispatches"] + 2
        assert qc["decode_steps"] == cc["decode_steps"] == 32
        assert cc["prefill_dispatches"] == 5 and cc["nonfinite_lanes"] == 0
        print(f"  faults kv={kv}: the quarantine and retry of R0 and R1 "
              f"(greedy, top-k; retried on lanes "
              f"{[q_hs[i].stats.lane for i in (0, 1)]}) add "
              f"{q_wall - c_wall:.3f}s of loop wall ({c_wall:.3f} -> "
              f"{q_wall:.3f}s) and 2 prefill dispatches; R0 done at "
              f"{c_hs[0].stats.t_done:.3f} -> {q_hs[0].stats.t_done:.3f}s, "
              f"R1 at {c_hs[1].stats.t_done:.3f} -> "
              f"{q_hs[1].stats.t_done:.3f}s; streams equal the clean "
              f"loop's: {same} of {len(want)}  [{smi}]")
        assert same == len(want)
        if kv == "bf16":
            fault_loops(run, kv, model, reqs, want, cc, c_wall, smi)
            fault_costs(model, params, quar, smi)
        del model, clean, quar
        gc.collect()
    return launches


def fault_loops(run, kv, model, reqs, want, cc, c_wall, smi):
    """The bf16 loops past quarantine: inert chaos, exhausted retries, a
    deadline under a stall (deadline and stall both max(DEADLINE_S,
    `c_wall`), the clean loop's wall), cancellation, a flood against
    `max_queue` and the degrade ladder."""
    inert, i_hs, _ = run("inert chaos", kv, model, reqs, chaos=ChaosConfig())
    assert [h.tokens for h in i_hs] == want
    ic = inert.counters
    assert all(ic[k] == cc[k] for k in FAULT_COUNTERS), (ic, cc)

    failing = fail_chaos()
    fail, f_hs, _ = run("exhausted retries", kv, model, reqs[:4],
                        max_retries=0, chaos=failing)
    assert f_hs[0].outcome == "failed" and f_hs[0].stats.retries == 1
    assert f_hs[0].tokens == want[0][:8 + FAIL_STEP]
    assert [h.tokens for h in f_hs[1:]] == want[1:4]
    assert fail.counters["failed_requests"] == 1

    ends = []

    def timed(loop, hs):
        step = loop._step_block

        def block():
            step()
            ends.append(loop._now())
        loop._step_block = block
        loop.run()

    # R1 samples, so R0 is prefilled alone as in the clean loop (a grouped
    # prefill may take other GEMM kernels, so other bits)
    deadline = stall = max(DEADLINE_S, c_wall)
    dl_reqs = [dict(reqs[0], max_new=64, deadline_s=deadline), reqs[1]]
    dead, d_hs, _ = run("deadline under a stall", kv, model, dl_reqs, timed,
                        chaos=ChaosConfig(stall_blocks=(1,), stall_s=stall))
    st = d_hs[0].stats
    expiry = st.t_arrival + deadline
    blocks = sum(expiry <= e <= st.t_done for e in ends)
    rel = [round(e - st.t_arrival, 3) for e in ends]
    print(f"  faults deadline kv={kv}: R0 (deadline {deadline:.3f}s) expired "
          f"inside the {stall:.3f}s stall before block 1; its lane freed "
          f"{(st.t_done - expiry) * 1e3:.1f} ms and {blocks} block(s) after "
          f"the expiry; block ends {rel}s after R0's arrival  [{smi}]")
    seen = (d_hs[0].outcome, blocks, len(d_hs[0].tokens), rel, deadline)
    assert rel[0] < deadline, ("block 0 ended after the deadline", seen)
    assert d_hs[0].outcome == "deadline" and blocks == 1, seen
    assert d_hs[0].tokens == want[0][:16], (
        "R0's stream parts from the clean loop's", seen,
        next((i for i, (a, b) in enumerate(zip(d_hs[0].tokens, want[0]))
              if a != b), None))
    assert d_hs[1].outcome == "done" and d_hs[1].tokens == want[1], (
        d_hs[1].outcome, len(d_hs[1].tokens))
    assert (dead.counters["deadline_expired"],
            dead.counters["chaos_stalls"]) == (1, 1), dead.counters

    def cancel(loop, hs):
        loop.schedule()
        loop._step_block()
        assert hs[0].cancel() and hs[4].cancel()
        loop.run()

    canc, k_hs, _ = run("cancel", kv, model, reqs[:5], cancel)
    assert [h.outcome for h in k_hs] == ["cancelled", "done", "done",
                                          "done", "cancelled"]
    assert k_hs[0].tokens == want[0][:8] and k_hs[4].tokens == []
    assert [h.tokens for h in k_hs[1:4]] == want[1:4]
    assert canc.counters["cancelled_requests"] == 2
    assert canc.counters["prefill_dispatches"] == 4     # R4 never prefilled

    burst = flood(model.cfg.vocab_size, 3 * FLOOD_QUEUE,
                  length=PROMPT_LEN // 2,
                  max_new=8, seed=SEED)

    def overflow(loop, hs):
        loop.run()                       # measures the block wall first
        hs.extend(loop.submit(Request(**kw)) for kw in burst[FLOOD_QUEUE:])
        loop.run()

    fl, fl_hs, _ = run("flood", kv, model, burst[:FLOOD_QUEUE], overflow,
                       max_queue=FLOOD_QUEUE)
    late = fl_hs[FLOOD_QUEUE:]
    outcomes = [h.outcome for h in fl_hs]
    hints = [h.stats.retry_after for h in late if h.outcome == "rejected"]
    print(f"  faults flood kv={kv}: {len(late)} submitted against max_queue "
          f"{FLOOD_QUEUE} after {FLOOD_QUEUE} served: {outcomes.count('done')}"
          f" done, {outcomes.count('rejected')} rejected with retry_after "
          f"{[round(x, 3) for x in hints]}s (block wall EMA "
          f"{fl._block_s_ema:.3f}s)  [{smi}]")
    assert outcomes.count("done") == 2 * FLOOD_QUEUE
    assert outcomes.count("rejected") == len(late) - FLOOD_QUEUE
    assert fl.counters["rejected_requests"] == len(late) - FLOOD_QUEUE
    assert all(x > 0 for x in hints) and len(hints) == FLOOD_QUEUE

    lad, l_hs, _ = run("ladder", kv, model, reqs, degrade=LADDER,
                       degrade_high=2)
    lc = lad.counters
    assert [h.tokens for h in l_hs] == want
    assert lc["degrade_down"] >= 1 and lc["degrade_up"] >= 1
    assert lad._degrade_level == 0
    assert lc["decode_steps"] < 8 * lc["decode_blocks"]


def fault_costs(model, params, loop, smi):
    """On the quarantine loop's final 4-lane state, blocks of COST_STEPS
    steps, clean and with one lane's logits poisoned at its second step:
    the aten ops and device events the fault mask adds, the card ms of the
    sentinel's op and of the mask's at [4, V], and host syncs (a faulted
    block must synchronise nowhere a clean one does not)."""
    dev, state, tok, gens = model.device, loop.state, loop.tok, loop._lane_gens
    steps = COST_STEPS
    active = torch.ones(LANES, dtype=torch.bool, device=dev)
    rem = torch.full((LANES,), 1 << 20, dtype=torch.int32, device=dev)
    greedy = (np.zeros(LANES, np.float32), np.zeros(LANES, np.int32),
              np.zeros(LANES, np.float32))
    mask = np.zeros((steps, LANES), bool)
    mask[1, 2] = True

    def block(fault):
        return decode_block_lanes(model, params, state, tok, active, rem, -1,
                                  gens, *greedy, steps, fault=fault)

    runs = {"clean": lambda: block(None), "faulted": lambda: block(mask)}
    finite = block(mask)[4].cpu().numpy()
    assert list(finite) == [True, True, False, True], finite
    ops = {k: aten_ops(fn) for k, fn in runs.items()}
    events = {k: device_events(fn) for k, fn in runs.items()}
    syncs = {k: host_syncs(fn) for k, fn in runs.items()}
    added = ops["faulted"] - ops["clean"]
    logits = model.decode_step(params, state, tok, active)[0]
    fault_t = torch.as_tensor(mask).to(dev)
    finite = torch.ones(LANES, dtype=torch.bool, device=dev)
    ok = torch.isfinite(logits).all(dim=-1) | ~active

    def sentinel():                     # decode_block_lanes' check, a step
        good = torch.isfinite(logits).all(dim=-1) | ~active
        finite.bitwise_and_(good)
        return active & good

    whole_ms = cuda_ms(sentinel)
    added_ms = cuda_ms(lambda: active & ok)
    mask_ms = cuda_ms(lambda: torch.where(fault_t[1, :, None], math.nan,
                                          logits))
    print(f"  faults costs at [{LANES}, {logits.shape[-1]}], a block of "
          f"{steps} steps: card time a step of the whole sentinel "
          f"{whole_ms:.4f} ms, of its op new in this slice (active & ok) "
          f"{added_ms:.4f} ms, of the fault mask's where {mask_ms:.4f} ms; a "
          f"faulted block adds aten ops {dict(added)}; device events "
          f"and card ms a step "
          f"{ {k: (n, round(ms / steps, 3)) for k, (n, ms) in events.items()} }"
          f"; host syncs a block {syncs}  [{smi}]")
    assert set(syncs["faulted"]) <= set(syncs["clean"]), syncs
    assert not ops["clean"] - ops["faulted"]


def three_pass_attend(cache, q, prune):
    """The composed decode step through the ops kernels, after the token
    write: approx_score over the mirror → group sum, selection bias and
    (block-local) top-k → gather → gather_attention. Returns out [B,Hq,dv]
    and the scores; in bf16 mode also checks approx_score_packed over the
    nibble-packed mirror (its 3-bit codes fit in 4) bit for bit."""
    b, hq, d = q.shape
    hk, s = cache.k.shape[1], cache.slots
    g, bh, dv = hq // hk, b * hk, cache.v.shape[-1]
    qq, qs = quant.quantize_query(q, prune.query_bits)
    mirror = (cache.kq if cache.kq is not None else cache.k).reshape(bh, s, d)
    sargs = (qq.reshape(bh, g, d), qs.reshape(bh, g), mirror,
             cache.kscale.reshape(bh, s),
             cache.valid.reshape(bh, s).to(torch.int8))
    scores = ops.approx_score(*sargs)                            # [BH,G,S]
    if cache.kq is not None:
        packed = approx_mod.approx_score_packed(
            sargs[0], sargs[1], quant.pack_int4(mirror), *sargs[3:])
        assert torch.equal(packed, scores), "packed scores differ"
    grouped = topk.gqa_group_scores(scores.reshape(b, hq, s), hk)
    biased = topk.apply_selection_bias(grouped, protected_mask(cache, prune),
                                       ~cache.valid)
    nb, sk = max(1, prune.select_blocks), prune.select_k
    _, idx = topk.exact_topk(biased.reshape(b, hk, nb, s // nb), sk // nb)
    idx = (idx + torch.arange(0, s, s // nb, device=q.device)[:, None]
           ).reshape(b, hk, sk)

    def rows(x):
        return torch.gather(x, 2, idx[..., None].expand(-1, -1, -1,
                                                        x.shape[-1]))

    k_sel, v_sel = rows(cache.k), rows(cache.v)
    if cache.quantized_kv:
        k_sel = k_sel.float() * torch.gather(cache.kscale, 2, idx)[..., None]
        v_sel = v_sel.float() * torch.gather(cache.vscale, 2, idx)[..., None]
    out = ops.gather_attention(q.reshape(bh, g, d), k_sel.reshape(bh, sk, d),
                               v_sel.reshape(bh, sk, dv),
                               torch.gather(cache.valid, 2, idx).reshape(
                                   bh, sk))
    return out.reshape(b, hq, dv)


def phase_paths(cfg, params, model):
    """One decode step from one prefilled state: the fused kernel and the
    three-pass step through the ops kernels vs the composed plain path.
    Returns the state, the next token and the launches of the three-pass
    step's kernels."""
    prompts = served_prompts(cfg.vocab_size)[:LANES]
    padded = np.zeros((len(prompts), PROMPT_LEN), np.int64)
    for i, (p, _) in enumerate(prompts):
        padded[i, :len(p)] = p
    lengths = [len(p) for p, _ in prompts]
    logits, st = model.prefill(params, {
        "tokens": torch.as_tensor(padded, device="cuda"),
        "length": torch.as_tensor(lengths, device="cuda")})
    assert torch.isfinite(logits).all()
    tok = torch.argmax(logits, -1)
    p0 = layer_params(params["seg0_dense"], 0)
    h = L.apply_norm(p0["ln1"], model._embed(params, tok), cfg.norm)
    cache0 = st.kv.layer(0)
    q, k, v = decode_qkv(p0["attn"], h, cfg, cache0)
    outs, accs = {}, {}
    for fused in (True, False):
        c = cache0.clone()
        prune = dataclasses.replace(model.prune, fused=fused)
        outs[fused] = decode_attention(c, q, k, v, prune)
        accs[fused] = c.acc
    c = cache0.clone()
    write_token(c, k, v, model.prune)
    torch.cuda.synchronize()
    reset_launches()
    three = three_pass_attend(c, q, model.prune)
    torch.cuda.synchronize()
    small = {n: x for n, x in launch_counts().items()
             if n not in ("ragged_decode", "fused_decode")}
    err = float((outs[True] - outs[False]).abs().max())
    err_acc = float((accs[True] - accs[False]).abs().max())
    err3 = float((three - outs[False]).abs().max())
    print(f"  paths kv={model.prune.kv_dtype} select_blocks="
          f"{model.prune.select_blocks}: layer-0 attention out, fused kernel "
          f"vs composed plain: max|d|={err:.3g} (atol {PATH_ATOL}); "
          f"accumulated scores max|d|={err_acc:.3g}; three-pass through "
          f"the ops kernels vs composed plain: max|d|={err3:.3g}, "
          f"launches {small}")
    assert torch.isfinite(outs[True]).all() and torch.isfinite(three).all()
    assert err <= PATH_ATOL and err_acc <= PATH_ATOL and err3 <= PATH_ATOL
    return st, tok, small


def phase_profile(params, model, st, tok, steps=4):
    """Where a decode step's time goes: host wall per step (no profiler),
    then the device time of the step's kernels under torch.profiler →
    (wall, kernel time) in ms a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        nonlocal st, tok
        for _ in range(steps):
            logits, st = model.decode_step(params, st, tok)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()

    run()                                                # warm
    t0 = time.monotonic()
    run()
    wall = (time.monotonic() - t0) / steps * 1e3         # ms per step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3 / steps    # ms per step
    launches = sum(e.count for e in kernels) / steps
    share = "not measured" if busy == 0 else f"{busy / wall:.1%} busy"
    print(f"  profile kv={model.prune.kv_dtype} select_blocks="
          f"{model.prune.select_blocks} B={tok.shape[0]}: decode step "
          f"{wall:.2f} ms host wall, {busy:.2f} ms of kernel time ({share}),"
          f" {launches:.0f} kernel launches per step")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3 / steps:8.3f} ms/step  "
              f"x{e.count // steps:<5d} {e.key[:80]}")
    return wall, busy


def phase_prefill_profile(cfg, params, model):
    """Where one whole-prompt prefill dispatch (4 x 2048, the served
    prompts) spends its time: host wall (no profiler), then the device time
    of its kernels under torch.profiler and the flash_prefill pair's
    share → (wall, kernel time) in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts = served_prompts(cfg.vocab_size)[:LANES]
    padded = np.zeros((LANES, PROMPT_LEN), np.int64)
    for i, (p, _) in enumerate(prompts):
        padded[i, :len(p)] = p
    batch = {"tokens": torch.as_tensor(padded, device="cuda"),
             "length": torch.as_tensor([len(p) for p, _ in prompts],
                                       device="cuda")}

    def run():
        model.prefill(params, batch)
        torch.cuda.synchronize()

    run()                                                # warm
    t0 = time.monotonic()
    run()
    wall = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    flash = sum(dev_us(e) for e in kernels
                if "flash_prefill" in e.key or "fold_columns" in e.key) / 1e3
    launches = sum(e.count for e in kernels)
    share = ("not measured" if busy == 0 else
             f"{busy / wall:.1%} busy, flash_prefill pair {flash:.2f} ms = "
             f"{flash / busy:.1%} of the kernel time")
    print(f"  profile prompt pass kv={model.prune.kv_dtype} B={LANES} "
          f"N={PROMPT_LEN}: {wall:.2f} ms host wall, {busy:.2f} ms of kernel "
          f"time ({share}), {launches} kernel launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:80]}")
    return wall, busy


# ---------------------------------------------------------------------------
# [dryrun]: the tooling layer (launch/dryrun.py, roofline.py, report.py) on
# phase 4's weights
# ---------------------------------------------------------------------------

ONE_CARD = {"data": 1, "model": 1}
ROOFLINE_SHARE_MAX = 1.05          # measured time below the bound: wrong
ALLOC_GROWTH_RTOL = 0.01           # the allocator's rounding of each tensor


def roofline_share(tag, cfg, shape, parts, measured, smi):
    """`roofline.summarize`'s bound on one card for `shape`'s work (its
    model flops, the bytes the step reads: `parts`, from
    `dryrun.step_read_bytes`) beside the measured (wall, kernel) ms;
    either share above ROOFLINE_SHARE_MAX fails."""
    mf = roofline.model_flops(cfg, shape)
    row = roofline.summarize({
        "flops": mf, "bytes_accessed": float(sum(parts.values())),
        "collective_bytes": None, "n_devices": 1, "model_flops": mf})
    bound_ms = row["step_time_bound_s"] * 1e3
    wall, busy = measured
    shares = {"host wall": bound_ms / wall}
    if busy > 0:                        # the profiler saw the card
        shares["kernel time"] = bound_ms / busy
    print(f"  {tag}: {mf:.4g} model flop, {sum(parts.values())} B read "
          f"{parts}; bound {bound_ms:.4f} ms "
          f"({row['dominant'].replace('_s', '')}: compute "
          f"{row['compute_s'] * 1e3:.4f} ms, memory "
          f"{row['memory_s'] * 1e3:.4f} ms); measured {wall:.2f} ms host "
          f"wall, {busy:.2f} ms kernel time; share of the bound "
          + ", ".join(f"{k} {v:.4g}" for k, v in shares.items())
          + f"  [{smi}]")
    assert all(v <= ROOFLINE_SHARE_MAX for v in shares.values()), (tag,
                                                                   shares)


def phase_dryrun(cfg, params, smi, step_ms, prompt_ms):
    """The dry run's shape-only count for phase 4's configuration on a
    one-card mesh against the trees on the card: the parameters and a
    fresh 4-lane decode state, byte for byte, and the allocator's growth
    while the state is made within ALLOC_GROWTH_RTOL; phase 4's decode
    steps and prompt pass beside `roofline.summarize`'s bound for the same
    work (the bytes each reads: `dryrun.step_read_bytes`); the CLI (`dryrun.main`, `report.main`) for longchat-7b x
    decode_32k on the 16 x 16 mesh; the H100 constants."""
    print(f"[dryrun] H100 constants (roofline.py): bf16 "
          f"{roofline.PEAK_FLOPS:g} flop/s, int8 "
          f"{roofline.PEAK_INT8_OPS:g} op/s, f32 "
          f"{roofline.PEAK_F32_FLOPS:g} flop/s, HBM {roofline.HBM_BW:g} B/s, "
          f"NVLink {roofline.NVLINK_BW_PER_DIRECTION:g} B/s each way; this "
          f"card: {smi}")
    params_nbytes = _tree_nbytes(params)
    parts = {}
    for kv in ("bf16", "int8"):
        prune = served_prune(kv)
        shape = ShapeConfig("served_decode", "decode", prune.slots, LANES)
        t = time.monotonic()
        parts[kv] = dryrun.probe_arg_bytes(cfg, shape, ONE_CARD, prune=prune)
        count_s = time.monotonic() - t
        model = Model(cfg, prune, device="cuda")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        st = model.init_decode_state(LANES)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        state_nbytes = _tree_nbytes(st)
        del st
        print(f"  kv={kv}: dry-run count (2- and 3-layer probes, one-card "
              f"mesh, {count_s:.2f}s) params {parts[kv]['params']} B, "
              f"{LANES}-lane decode state at {prune.slots} slots "
              f"{parts[kv]['state']} B; on the card: params "
              f"{params_nbytes} B, a fresh state {state_nbytes} B, "
              f"memory_allocated grew {grown} B "
              f"({grown / state_nbytes - 1:+.3%})")
        assert parts[kv]["params"] == params_nbytes, (parts, params_nbytes)
        assert parts[kv]["state"] == state_nbytes, (parts, state_nbytes)
        assert abs(grown - state_nbytes) <= ALLOC_GROWTH_RTOL * state_nbytes
    for (kv, blocks), measured in sorted(step_ms.items()):
        prune = served_prune(kv, blocks)
        shape = ShapeConfig("served_decode", "decode", prune.slots, LANES)
        read = dryrun.step_read_bytes(dryrun.build_cell(cfg, shape,
                                                        prune=prune),
                                      ONE_CARD, parts[kv])
        roofline_share(f"decode step kv={kv} select_blocks={blocks} "
                       f"B={LANES} (K/V rows of {prune.select_k} winners "
                       f"of {prune.slots} slots)", cfg, shape, read,
                       measured, smi)
    shape = ShapeConfig("served_prefill", "prefill", PROMPT_LEN, LANES)
    prefill = dryrun.arg_bytes(dryrun.build_cell(
        cfg, shape, prune=served_prune("bf16")), ONE_CARD)
    roofline_share(f"prompt pass kv=bf16 B={LANES} N={PROMPT_LEN}", cfg,
                   shape, prefill, prompt_ms, smi)
    with tempfile.TemporaryDirectory() as out:
        assert dryrun.main(["--arch", "longchat-7b", "--shape", "decode_32k",
                            "--mesh", "single", "--out", out]) == 0
        with open(Path(out) / "longchat-7b_decode_32k_single.json") as f:
            rec = json.load(f)
        assert rec["cost_source"] == "analytic", rec
        assert rec["peak_bytes_per_dev"] is None, rec
        assert 0 < rec["bytes_accessed"] < rec["arg_bytes_per_dev"], rec
        report.main(["--dir", out])


# ---------------------------------------------------------------------------
# phase 8b ([sharded]): the lane-sharded ServeLoop on phase 4's weights
# ---------------------------------------------------------------------------

SHARDS = 2                         # ServeLoop(mesh=2): 2 shards x 2 lanes
SHARDED_RUNS = (("bf16", 1), ("int8", 4))


def first_parting(got, want):
    """[(request, the first step where its streams part)] of the unequal
    streams."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            out.append((i, next((j for j, (a, b) in enumerate(zip(g, w))
                                 if a != b), min(len(g), len(w)))))
    return out


def sharded_teacher(cfg, params, model, steps=16):
    """The batch size alone: the 4 served prompts prefilled and decoded as
    one 4-lane batch (the one-shard loop's) and as two 2-lane ones (the
    shards'), fed the same tokens (the 4-lane side's greedy choices) for
    `steps` steps → the top-1 agreement over steps x LANES."""
    batch = served_batch(cfg)
    n = LANES // SHARDS
    logits, st = model.prefill(params, batch)
    halves = [model.prefill(params, {k: v[i * n:(i + 1) * n]
                                     for k, v in batch.items()})
              for i in range(SHARDS)]
    tok = torch.argmax(logits, -1)
    agree = int((torch.cat([h[0] for h in halves]).argmax(-1) == tok).sum())
    states = [h[1] for h in halves]
    for _ in range(steps - 1):
        lk, st = model.decode_step(params, st, tok)
        parts = []
        for i in range(SHARDS):
            lh, states[i] = model.decode_step(params, states[i],
                                              tok[i * n:(i + 1) * n])
            parts.append(lh)
        tok = torch.argmax(lk, -1)
        agree += int((torch.cat(parts).argmax(-1) == tok).sum())
    return agree


def phase_sharded(cfg, params, smi, one_shard):
    """Phase 4's 8 requests through `ServeLoop(mesh=SHARDS)`: bf16 KV with
    select_blocks 1 (ragged_decode) and int8 KV with select_blocks 4
    (fused_decode). Each decode step launches the kernel once per cache
    layer per shard, each prompt pass flash_prefill once per cache layer,
    nothing else. The streams are compared with phase 4's one-shard run of
    the same configuration (`one_shard[(kv, blocks)]`); where they part,
    the first step of each parting is printed, each shard's requests are
    served again by a one-shard loop of lanes_per_shard lanes (its streams
    must equal that shard's), and the gate becomes the teacher-forced
    top-1 agreement of 4-lane and 2-lane batches (TEACHER_AGREE_MIN).
    Returns the launches of each kernel."""
    launches = {"ragged_decode": 0, "fused_decode": 0, "flash_prefill": 0}
    mesh = make_serve_mesh(SHARDS)
    lps = LANES // SHARDS
    print(f"[sharded] ServeLoop(mesh={SHARDS}) over {mesh}: {SHARDS} shards "
          f"x {lps} lanes on {torch.cuda.device_count()} card(s)  [{smi}]")
    prompts = served_prompts(cfg.vocab_size)
    for kv, blocks in SHARDED_RUNS:
        t = time.monotonic()
        prune = served_prune(kv, blocks)
        kernel = "fused_decode" if blocks > 1 else "ragged_decode"
        model = Model(cfg, prune, device="cuda")
        layers = model.attn_layer_count()
        loop = ServeLoop(model, params, lanes=LANES, max_new=NEW_TOKENS,
                         block=8, mesh=mesh, device="cuda")
        handles = [(loop.submit(Request(prompt=p, max_new=m)), m)
                   for p, m in prompts]
        torch.cuda.synchronize()
        reset_launches()
        for name in PLAIN_ON_CARD:
            PLAIN_ON_CARD[name] = 0
        t0 = time.monotonic()
        stats = loop.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = launch_counts()
        n = counts.pop(kernel)
        flash = counts.pop("flash_prefill")
        c = loop.counters
        steps = c["decode_steps"]
        agg = loop.aggregate()
        toks = sum(len(s.tokens) for s in stats)
        shard_rows = ", ".join(
            f"shard {i}: {agg[f'shard{i}_tokens']:.0f} tokens, "
            f"{agg[f'shard{i}_tok_s']:.1f} tok/s" for i in range(SHARDS))
        print(f"  sharded serve {cfg.name} kv={kv} select_blocks={blocks}: "
              f"{len(stats)} requests, {toks} tokens in {wall:.3f}s = "
              f"{toks / wall:.1f} tok/s, p50 TTFT {agg['p50_ttft_s']:.3f}s; "
              f"{shard_rows}; {agg['tokens_per_dispatch']:.2f} tokens a "
              f"block dispatch; {steps} decode steps a shard, "
              f"{c['prefill_dispatches']} prefills ({c['grouped_requests']} "
              f"requests group-admitted); {kernel} launches {n} = {layers} "
              f"layers x {SHARDS} shards x {steps} steps: "
              f"{n == layers * SHARDS * steps} ({n / max(steps, 1):.0f} a "
              f"step); flash_prefill launches {flash} = {layers} x "
              f"{c['prefill_dispatches']}; plain prompt attention on the card "
              f"{PLAIN_ON_CARD}; other kernels {counts}  [{smi}]")
        assert all(h.done and len(h.tokens) == m for h, m in handles)
        assert c["nonfinite_lanes"] == 0
        assert n == layers * SHARDS * steps and n > 0
        assert flash == layers * c["prefill_dispatches"] and flash > 0
        assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
        assert not any(counts.values()), counts
        assert sum(agg[f"shard{i}_tokens"] for i in range(SHARDS)) == toks
        launches[kernel] += n
        launches["flash_prefill"] += flash
        got = [h.tokens for h, _ in handles]
        parted = first_parting(got, one_shard[(kv, blocks)])
        print(f"  streams against phase 4's one-shard loop ({LANES} lanes): "
              f"{len(prompts) - len(parted)} of {len(prompts)} equal; parted "
              f"(request, first step): {parted}")
        if parted:
            for sh in range(SHARDS):
                mine = [i for i, (h, _) in enumerate(handles)
                        if h.stats.lane // lps == sh]
                solo = ServeLoop(model, params, lanes=lps,
                                 max_new=NEW_TOKENS, block=8, device="cuda")
                hs = [solo.submit(Request(prompt=prompts[i][0],
                                          max_new=prompts[i][1]))
                      for i in mine]
                solo.run()
                same = [h.tokens for h in hs] == [got[i] for i in mine]
                print(f"  shard {sh}'s requests {mine} through a one-shard "
                      f"loop of {lps} lanes: streams equal the shard's "
                      f"{same}")
                assert same, sh
            agree = sharded_teacher(cfg, params, model)
            print(f"  teacher-forced, {LANES}-lane batch vs {SHARDS} x {lps}-"
                  f"lane batches from the same prompts: top-1 equal in "
                  f"{agree} of {16 * LANES} (held to {TEACHER_AGREE_MIN})")
            assert agree >= TEACHER_AGREE_MIN, agree
        print(f"[sharded] kv={kv} select_blocks={blocks} phase "
              f"{time.monotonic() - t:.1f}s")
        del loop, handles, stats, model
    return launches


# ---------------------------------------------------------------------------
# phase 8d: long-context decode on the decode kernels' long route
# ---------------------------------------------------------------------------

LONG_PROMPTS = (32000, 24576)      # served at decode_32k's pruning
LONG_NEW = 16                      # new tokens a request, teacher steps
LONG_CHUNK = 4096                  # chunked admission's slice
LONG_STEPS = 4                     # long_500k's counted decode steps


def long_prune(shape, kv):
    """The reference dry run's pruning of cell `shape` (`dryrun.make_prune`
    on SHAPES_BY_NAME: heavy = slots - 64, select_k = min(2048, slots //
    16), 3-bit scores, 4-bit queries) with `kv` K/V, on the fused engine."""
    prune = dryrun.make_prune(SHAPES_BY_NAME[shape],
                              opts=("kvint8",) if kv == "int8" else ())
    return dataclasses.replace(prune, fused=True)


def phase_long_served(cfg, params, smi):
    """longchat-7b at decode_32k's pruning (S = 32,768, select_k = 2,048)
    on phase 4's weights: the LONG_PROMPTS through ServeLoop on 2 lanes
    with chunk_prefill = LONG_CHUNK, int8 K/V (a bf16 chunked admission's
    17.2 GB workspace and the 21.5 GB one-lane state it fills do not fit
    beside two bf16 lanes and the weights on an 80 GB card), each decode
    step 32 ragged_decode_long launches and no other decode kernel; then
    bf16 K/V on 1 lane: the 32,000-token prompt teacher-forced through the
    kernel path and the composed plain path for LONG_NEW steps, top-1 held
    at TEACHER_AGREE_MIN of 64. → (launches, the loop's aggregate)."""
    rng = np.random.default_rng(SEED)
    prompts = [(rng.integers(0, cfg.vocab_size, n), LONG_NEW)
               for n in LONG_PROMPTS]
    torch.cuda.reset_peak_memory_stats()
    kernel, n, flash, model, handles, agg = phase_serve(
        cfg, params, "int8", smi, 1, chunk=LONG_CHUNK,
        prune=long_prune("decode_32k", "int8"), lanes=len(prompts),
        prompts=prompts, kernel="ragged_decode_long")
    print(f"  decode_32k serve: peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)  [{smi}]")
    del model, handles
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg, long_prune("decode_32k", "bf16"), device="cuda")
    phase_teacher(cfg, params, model, steps=LONG_NEW, batch={
        "tokens": torch.as_tensor(prompts[0][0][None], device="cuda")})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {kernel: n, "flash_prefill": flash}, agg


def cache_decode_args(cache, q, prune):
    """The fused engine's kernel inputs for one layer's cache (after the
    token write) and queries q [B, Hq, d], as `_fused_decode_attend`
    builds them → (fills [BH], the eleven inputs)."""
    b, hq, d = q.shape
    hk, s = cache.k.shape[1], cache.slots
    qq, qs = quant.quantize_query(q, prune.query_bits)
    mirror = cache.kq if cache.kq is not None else cache.k
    ones = torch.ones((b, hk, s), device=q.device)
    kscale, vscale = ((cache.kscale, cache.vscale) if cache.quantized_kv
                      else (ones, ones))

    def bhf(x):
        return x.reshape((b * hk,) + tuple(x.shape[2:])).contiguous()

    args = [q.reshape(b * hk, hq // hk, d), qq.reshape(b * hk, hq // hk, d),
            qs.reshape(b * hk, hq // hk), bhf(mirror), bhf(cache.kscale),
            bhf(kscale), bhf(vscale), bhf(cache.valid.to(torch.int8)),
            bhf(protected_mask(cache, prune).to(torch.int8)), bhf(cache.k),
            bhf(cache.v)]
    return torch.repeat_interleave(cache.fill, hk), args


LONG_STEPS_FILE = ROOT / "build" / "long_500k_steps.pt"


def long_rows(li, heads, n, d):
    """Layer `li`'s prompt K/V rows and column sums for kv-heads `heads`,
    each head's drawn on the card from a seed of its own, so a rank that
    holds some heads draws them alone: (k, v [1, len(heads), n, d] bf16,
    acc [1, len(heads), n] f32)."""
    gen = torch.Generator(device="cuda")
    ks, vs, accs = [], [], []
    for h in heads:
        gen.manual_seed(SEED + 1000 * li + h)
        ks.append(torch.randn((n, d), generator=gen, device="cuda").to(
            torch.bfloat16))
        vs.append(torch.randn((n, d), generator=gen, device="cuda").to(
            torch.bfloat16))
        accs.append(torch.rand((n,), generator=gen, device="cuda"))
    return (torch.stack(ks)[None], torch.stack(vs)[None],
            torch.stack(accs)[None])


def long_state(model, cfg, prune):
    """A fresh one-lane decode state of `model` (granite-3-2b at
    long_500k), every layer's cache filled through `prefill_fill` from
    `long_rows`."""
    st = model.init_decode_state(1)
    hk, d, n = cfg.n_kv_heads, cfg.head_dim, prune.heavy_budget
    for li in range(model.attn_layer_count()):
        k_rows, v_rows, acc = long_rows(li, range(hk), n, d)
        _store_layer(st, li, prefill_fill(st.kv.layer(li), k_rows, v_rows,
                                          acc, prune))
        del k_rows, v_rows, acc
    return st


def teacher_logits(model, params, st, tokens):
    """`Model.decode_step` on `st` fed `tokens` ([T] long), one a step →
    the steps' logits [T, vocab] f32 on the host."""
    steps = []
    for tok in tokens:
        logits, st = model.decode_step(params, st, tok.view(1).to(
            st.kv.k.device))
        steps.append(logits)
    return torch.cat(steps).float().cpu()


def merge_blocks(stages):
    """`sharding.merge_shards` over the slot blocks' stages in one
    process, its two all-reduces by hand (a maximum; a sum, which over two
    blocks is a + b in either order) → (the row's (max, sum), out)."""
    parts = [(x.mz(), *x.partials()) for x in stages]
    top_m = functools.reduce(torch.maximum, [p[0][..., 0] for p in parts])
    top_x = functools.reduce(torch.maximum, [p[2] for p in parts])

    def weight(x, top):
        return torch.where(x > -math.inf, torch.exp(x - top),
                           torch.zeros_like(x))
    zs = functools.reduce(torch.add, [p[0][..., 1] * weight(p[0][..., 0],
                                                            top_m)
                                      for p in parts])
    nums = functools.reduce(torch.add, [p[1] * weight(p[2], top_x)[..., None]
                                        for p in parts])
    dens = functools.reduce(torch.add, [p[3] * weight(p[2], top_x)
                                        for p in parts])
    out = torch.where((top_x > -math.inf)[..., None],
                      nums / torch.clamp(dens[..., None], min=1e-30),
                      torch.zeros_like(nums))
    return torch.stack([top_m, zs], dim=-1), out


class laid_out_on_one_card:
    """Inside the block, `Model.decode_step` on a whole one-card state
    computes as [slots]' ranks do: `decode_qkv` projects the kv-heads as
    `head_blocks` blocks, each as the rank that holds it does (the
    columns of its heads), and the global race of `ops.fused_decode`
    runs the decode kernels' sharded route over `slot_blocks` blocks of
    the slots, one after another, the collectives by hand
    (`merge_blocks`). `fault` (`slots_witness` only) breaks it on
    purpose: "qkv", the last head block projected with the first block's
    heads on layers >= 1 (a wrong head offset); "gather", the head
    blocks' attention outputs joined in the wrong order on layers >= 1;
    "gather_last", that on the last layer only."""

    def __init__(self, head_blocks, slot_blocks, layers, fault=None):
        self.parts, self.n, self.layers = head_blocks, slot_blocks, layers
        self.fault = fault

    def __enter__(self):
        self.saved = (layer_mod.decode_qkv, layer_mod.decode_attention,
                      ops.fused_decode)
        qkv_of, attend_of, whole_decode = self.saved
        calls = [0]

        def qkv(p, x, cfg, cache):
            li = calls[0] % self.layers
            calls[0] += 1
            hk = cache.k.shape[1] // self.parts
            blocks = []
            for i in range(self.parts):
                h0 = (0 if self.fault == "qkv" and li and i == self.parts - 1
                      else i * hk)
                blocks.append(qkv_of(p, x, cfg, types.SimpleNamespace(
                    k=cache.k[:, :hk], step=cache.step,
                    heads=types.SimpleNamespace(offset=h0))))
            return tuple(torch.cat(t, 1) for t in zip(*blocks))

        def attend(*a, **kw):
            out = attend_of(*a, **kw)
            li = (calls[0] - 1) % self.layers
            if (self.fault == "gather" and li
                    or self.fault == "gather_last" and li == self.layers - 1):
                out = torch.cat(out.chunk(self.parts, 1)[::-1], 1)
            return out

        def fused_decode(*args, select_k, num_blocks=1, fills=None):
            if num_blocks != 1:
                return whole_decode(*args, select_k=select_k,
                                    num_blocks=num_blocks, fills=fills)
            w = args[3].shape[1] // self.n
            sts = [ragged_mod.ShardStages(
                "ragged_decode", {"ragged_decode_shard": 0}, fills,
                *args[:3], *(a[:, i * w:(i + 1) * w].contiguous()
                             for a in args[3:]),
                select_k=select_k, offset=i * w) for i in range(self.n)]
            for x in sts:
                x.race(select_k, final=False)
            gathered = torch.stack([x.candidates() for x in sts])
            for x in sts:
                x.merge(gathered, select_k)
                x.attend()
            mz, out = merge_blocks(sts)
            for x in sts:
                x.set_mz(mz)
            return out, torch.cat([x.probs() for x in sts], dim=1)
        layer_mod.decode_qkv, layer_mod.decode_attention = qkv, attend
        ops.fused_decode = fused_decode
        return self

    def __exit__(self, *exc):
        (layer_mod.decode_qkv, layer_mod.decode_attention,
         ops.fused_decode) = self.saved
        return False


def phase_long_500k(smi):
    """granite-3-2b at full width and depth at long_500k's pruning (S =
    524,288, select_k = 2,048), one lane, int8 K/V, random bf16 weights
    from the seed: every layer's cache filled through `prefill_fill` from
    524,224 K/V rows and column sums drawn from the seed, a seed a layer
    and head (`long_rows`; no 500k-token prompt pass), then LONG_STEPS
    `Model.decode_step`s (their tokens and logits saved to
    LONG_STEPS_FILE for `[slots]`), each 40
    ragged_decode_long launches and no other kernel, finite logits; the
    same steps on a fresh state computed as [slots]' ranks compute them
    (`laid_out_on_one_card`; saved too), their logits' difference from
    the whole state's printed; the
    step's wall and kernel time (torch.profiler); layer 0's next step on a
    clone of its cache: the kernel against its plain version on the
    layer's own inputs (OUT_ATOL, PROBS_ATOL; probs at scale, PROBS_RTOL
    and PROBS_SUM_RTOL), against gather_attention over the same winners
    (the plain race's, GATHER_ATOL), and the fused engine's attention
    against the composed path's (PATH_ATOL; the accumulated scores within
    PROBS_RTOL of one step's probs at scale plus two roundings; the
    composed race's winner sets printed). → launches."""
    cfg = get_config("granite-3-2b")
    prune = long_prune("long_500k", "int8")
    model = Model(cfg, prune, device="cuda")
    params = model.init(SEED)
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    st = long_state(model, cfg, prune)
    hk, d, n = cfg.n_kv_heads, cfg.head_dim, prune.heavy_budget
    layers = model.attn_layer_count()
    torch.cuda.synchronize()
    state_gib = sum(x.numel() * x.element_size()
                    for x in vars(st.kv).values()
                    if isinstance(x, torch.Tensor)) / 2 ** 30
    print(f"  long_500k granite-3-2b: {layers} caches of {prune.slots} "
          f"slots filled with {n} rows each through prefill_fill in "
          f"{time.monotonic() - t:.1f}s, state {state_gib:.2f} GiB int8 "
          f"K/V  [{smi}]")
    assert bool((st.kv.fill == n).all())
    tok = torch.zeros((1,), dtype=torch.long, device="cuda")
    reset_launches()
    t = time.monotonic()
    fed, steps = [], []
    for _ in range(LONG_STEPS):
        fed.append(tok)
        logits, st = model.decode_step(params, st, tok)
        steps.append(logits)
        tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t) / LONG_STEPS * 1e3
    counts = launch_counts()
    n_long = counts.pop("ragged_decode_long")
    print(f"  long_500k: {LONG_STEPS} decode steps, {wall:.1f} ms a step "
          f"(host wall, first steps), ragged_decode_long launches {n_long} "
          f"= {layers} x {LONG_STEPS}: {n_long == layers * LONG_STEPS}; "
          f"other kernels {counts}; fill {int(st.kv.fill.min())}")
    assert n_long == layers * LONG_STEPS and not any(counts.values()), counts
    assert torch.isfinite(logits).all()
    # the same state on with LONG_NB selection blocks: fused_decode_long
    blocked = Model(cfg, dataclasses.replace(prune, select_blocks=LONG_NB),
                    device="cuda")
    reset_launches()
    for _ in range(2):
        logits, st = blocked.decode_step(params, st, tok)
        tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_fused = counts.pop("fused_decode_long")
    print(f"  long_500k select_blocks={LONG_NB}: 2 decode steps, "
          f"fused_decode_long launches {n_fused} = {layers} x 2: "
          f"{n_fused == layers * 2}; other kernels {counts}")
    assert n_fused == layers * 2 and not any(counts.values()), counts
    assert torch.isfinite(logits).all()
    assert bool((st.kv.fill == n + LONG_STEPS + 2).all())

    # layer 0's next step, on clones of its cache
    p0 = layer_params(params["seg0_dense"], 0)
    h = L.apply_norm(p0["ln1"], model._embed(params, tok), cfg.norm)
    cache0 = st.kv.layer(0)
    q, k, v = decode_qkv(p0["attn"], h, cfg, cache0)
    c = cache0.clone()
    write_token(c, k, v, prune)
    fills, args = cache_decode_args(c, q, prune)
    out_k, probs_k = ragged_mod.ragged_decode(fills, *args,
                                              select_k=prune.select_k)
    out_p, probs_p = ref.fused_decode_ref(*args, select_k=prune.select_k)
    _, idx = ref.decode_race(*args[1:5], args[7], args[8],
                             select_k=prune.select_k)
    k_sel = torch.gather(args[9], 1, idx[..., None].expand(-1, -1, d))
    v_sel = torch.gather(args[10], 1, idx[..., None].expand(-1, -1, d))
    out_g = ops.gather_attention(
        args[0], k_sel.float() * torch.gather(args[5], 1, idx)[..., None],
        v_sel.float() * torch.gather(args[6], 1, idx)[..., None],
        torch.gather(args[7], 1, idx))
    e_plain = float((out_k - out_p).abs().max())
    e_probs = float((probs_k - probs_p).abs().max())
    g = cfg.n_heads // hk
    live = (args[7] != 0) & (torch.arange(prune.slots, device="cuda")[None]
                             < fills[:, None])
    e_scale, e_sum = probs_at_scale(probs_k, probs_p, live, g)
    e_gather = float((out_k - out_g).abs().max())
    outs, accs = {}, {}
    for fused in (True, False):
        cc = cache0.clone()
        outs[fused] = decode_attention(cc, q, k, v, dataclasses.replace(
            prune, fused=fused))
        accs[fused] = cc.acc
        del cc
    scores = ops.approx_score(args[1], args[2], args[3], args[4], args[7])
    biased = topk.apply_selection_bias(
        topk.gqa_group_scores(scores.reshape(1, cfg.n_heads, -1), hk),
        protected_mask(c, prune), ~c.valid)
    _, idx_c = topk.exact_topk(biased, prune.select_k)
    same = [torch.equal(torch.sort(a).values, torch.sort(b).values)
            for a, b in zip(idx, idx_c.reshape(idx.shape))]
    e_path = float((outs[True] - outs[False]).abs().max())
    e_acc = float((accs[True] - accs[False]).abs().max())
    # acc = acc * decay + probs on both paths: they part by their probs'
    # difference (held at scale) and a rounding of each sum
    acc = accs[False].reshape(probs_p.shape).abs()         # f32: its ulp
    acc_ulp = (torch.nextafter(acc, torch.full_like(acc, math.inf))
               - acc).double()
    acc_limit = (PROBS_RTOL * (probs_p.double().abs()
                               + g / live.sum(-1, keepdim=True).double())
                 + 2 * acc_ulp)
    acc_share = float(((accs[True] - accs[False]).reshape(acc.shape).double()
                       .abs() / acc_limit).max())
    print(f"  long_500k layer 0 (BH={hk} G={cfg.n_heads // hk} d={d} S="
          f"{prune.slots} k={prune.select_k} int8): ragged_decode_long vs "
          f"plain max|dout|={e_plain:.3g} max|dprobs|={e_probs:.3g}, at "
          f"scale {e_scale:.3g} (row sums {e_sum:.3g}); vs "
          f"gather_attention over the plain race's winners "
          f"max|dout|={e_gather:.3g}; fused engine vs composed path "
          f"max|dout|={e_path:.3g}, accumulated scores max|d|={e_acc:.3g} "
          f"= {acc_share:.3g} of its limit ({PROBS_RTOL:g} x (|probs| + G "
          f"/ live) + 2 ulp of acc); the composed race's winner set the "
          f"kernel's in {sum(same)} of {len(same)} rows")
    assert e_plain <= OUT_ATOL and e_probs <= PROBS_ATOL
    assert e_scale <= PROBS_RTOL and e_sum <= PROBS_SUM_RTOL
    assert e_gather <= GATHER_ATOL
    assert e_path <= PATH_ATOL and acc_share <= 1.0
    del c, args, out_p, probs_p, k_sel, v_sel, scores, biased, outs, accs
    del live, acc, acc_ulp, acc_limit
    wall_ms, busy_ms = phase_profile(params, model, st, tok, steps=2)
    print(f"  long_500k decode step: {wall_ms:.2f} ms host wall, "
          f"{busy_ms:.2f} ms of kernel time; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB  [{smi}]")
    del st, blocked, cache0, q, k, v, h
    # the same steps computed as [slots]' ranks compute them, for its
    # comparison
    fed, whole = torch.cat(fed).cpu(), torch.cat(steps).float().cpu()
    with laid_out_on_one_card(SLOTS_MESH[1], SLOTS_MESH[0], layers):
        laid = teacher_logits(model, params, long_state(model, cfg, prune),
                              fed)
    torch.save({"tokens": fed, "logits": whole, "laid": laid},
               LONG_STEPS_FILE)
    print(f"  long_500k computed as [slots]' ranks do ({SLOTS_MESH[1]} head "
          f"blocks' projections, the sharded route over {SLOTS_MESH[0]} slot "
          f"blocks, the collectives by hand) against the whole state's "
          f"steps, the same {LONG_STEPS} steps from the same state: logits "
          f"max|d| {float((laid - whole).abs().max()):.4g}, greedy argmax "
          f"equal in {int((laid.argmax(-1) == whole.argmax(-1)).sum())} of "
          f"{LONG_STEPS}")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return ({"ragged_decode_long": n_long, "fused_decode_long": n_fused},
            {"wall_ms": wall_ms, "kernel_ms": busy_ms,
             "layer0_max_abs_err": max(e_plain, e_probs)})


# ---------------------------------------------------------------------------
# the [mesh] phase: the collective paths in a 4-rank world
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_STEPS = 80                    # 64 appends fill the cache, 16 evict
MESH_EVICTING_MIN = 8
MESH_ATOL = 2e-4                   # the CPU tests' tolerance
# the slot-sharded decode's runs: (K/V dtype, selection blocks): one block
# a rank and the global race, each with bf16 and int8 K/V
MESH_RUNS = tuple(itertools.product(("bf16", "int8"), (4, 1)))


def mesh_backend() -> str:
    """NCCL with a card a rank, gloo otherwise (NCCL refuses two ranks on
    one card)."""
    return "nccl" if torch.cuda.device_count() >= MESH_RANKS else "gloo"


PLAIN_ATTENTION = (("attention", "_dense_attend"),
                   ("attention", "_gathered_attend"),
                   ("attention", "_gathered_attend_blocked"),
                   ("attention", "_owned_attend_shardmap"),
                   ("ref", "fused_decode_ref"),
                   ("ref", "shard_attend_ref"))


class plain_attention_calls:
    """Counts the calls of every plain attention of a decode step (the
    composed path's and the decode kernels' plain versions) inside the
    block: `count[0]`."""

    def __enter__(self):
        from repro_torch.core import attention as attention_mod
        mods = {"attention": attention_mod, "ref": ref}
        self.count, self.saved = [0], []
        for mod, name in PLAIN_ATTENTION:
            orig = getattr(mods[mod], name)

            def fn(*a, _orig=orig, **kw):
                self.count[0] += 1
                return _orig(*a, **kw)
            self.saved.append((mods[mod], name, orig))
            setattr(mods[mod], name, fn)
        return self.count

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)
        return False


def mesh_decode(mesh, dev, kv, nb):
    """longchat-7b's full-width decode layer (4 lanes x 32 kv-heads, d 128,
    S 1088, select_k 128) on a cache slot-sharded over the 4 ranks (272
    slots a rank), from a prefilled cache, MESH_STEPS steps, on the fused
    engine: the decode kernels' sharded route, with `nb` selection blocks
    (4: one block a rank, `fused_decode_shard`; 1: the global race,
    `ragged_decode_shard`). Each step against the port's unsharded fused
    engine on the whole cache on this card (the single-CTA kernels) and
    against the plain version, the sharded composed path (plain PyTorch
    on a second copy of the block). The prefill keeps 1024 of the 1088
    slots, so the steps past the 64th evict, each choosing its write slot
    by the all-gather of every rank's (min, index). No plain attention
    runs in the kernel route's steps. Returns a dict of the worst errors,
    the block's fields against the whole cache's, the evicting steps, the
    collectives' device and the launches by route."""
    b, h, d = LANES, 32, 128
    prune = served_prune(kv, nb, fused=True)
    plain_prune = dataclasses.replace(prune, fused=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    whole = prefill_fill(init_cache(b, h, d, prune.slots, prune,
                                    torch.bfloat16, device=dev),
                         rnd(b, h, PROMPT_LEN, d), rnd(b, h, PROMPT_LEN, d),
                         rnd(b, h, PROMPT_LEN).abs(), prune)
    cache = shard_cache(whole, mesh, 4)
    plain = cache.clone()

    def mine(x):
        return shard_rows(x, mesh, 4, b)
    worst_k = worst_p = 0.0
    evicting = calls = 0
    reset_launches()
    for _ in range(MESH_STEPS):
        q, kn, vn = rnd(b, h, d), rnd(b, h, d), rnd(b, h, d)
        evicting += int(bool((whole.fill >= prune.slots).all()))
        want = decode_attention(whole, q, kn, vn, prune)
        with use_mesh(mesh):
            with plain_attention_calls() as count:
                out = decode_attention(cache, *map(mine, (q, kn, vn)), prune)
            calls += count[0]
            out_p = decode_attention(plain, *map(mine, (q, kn, vn)),
                                     plain_prune)
        worst_k = max(worst_k, float((out - mine(want)).abs().max()))
        worst_p = max(worst_p, float((out - out_p).abs().max()))
    counts = launch_counts()
    blk = shard_cache(whole, mesh, 4)
    acc = float((cache.acc - blk.acc).abs().max())
    same = all(torch.equal(getattr(cache, f), getattr(blk, f))
               for f in ("valid", "pos", "fill", "step"))
    return {"vs_unsharded": worst_k, "vs_plain": worst_p, "acc": acc,
            "same": same, "evicting": evicting, "plain_calls": calls,
            "device": str(cache.acc.device),
            "launches": {k: n for k, n in counts.items() if n}}


def mesh_latent(mesh, dev, kv):
    """deepseek-v3-671b's latent race at full width (128 heads over one
    576-wide latent, S 1088, 4 blocks) at full budget (select_k = S, as the
    reference's own shard_map test) against dense latent attention over
    the whole cache on this card. Returns the worst ctx |d|."""
    mcfg = get_config("deepseek-v3-671b")
    m = mcfg.mla
    b, hq, lat, s = LANES, mcfg.n_heads, m.latent_dim, PROMPT_LEN // 2 + 64
    scale_dim = m.qk_nope_dim + m.qk_rope_dim
    prune = baselines.unicaim(heavy=s - 64, reserve=64, select_k=s,
                              select_blocks=4, fused=False, kv_dtype=kv)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cache = init_cache(b, 1, lat, s, prune, torch.bfloat16, device=dev,
                       latent=True)
    for _ in range(s - 24):                      # 24 slots stay empty
        write_token(cache, torch.randn((b, 1, lat), generator=gen,
                                       device=dev), None, prune)
    q = torch.randn((b, hq, lat), generator=gen, device=dev)
    qq, qs = quant.quantize_query(q, prune.query_bits)
    mirror = cache.kq if cache.kq is not None else cache.k
    s_apx = scoring.approx_scores(qq, qs, mirror, cache.kscale, cache.valid)
    biased = topk.apply_selection_bias(
        topk.gqa_group_scores(s_apx, 1), protected_mask(cache, prune),
        ~cache.valid)
    u = cache.k_values()[:, 0].float()
    logits = torch.einsum("bhk,bsk->bhs", q, u) / math.sqrt(scale_dim)
    logits = torch.where(cache.valid[:, 0][:, None, :], logits,
                         torch.full_like(logits, topk.NEG_INF))
    want = torch.einsum("bhs,bsk->bhk", torch.softmax(logits, -1),
                        u[:, :, :m.kv_lora_rank])
    local = shard_cache(cache, mesh, 4)
    _, slot_axes = slot_layout(mesh, 4, b)
    step = s // mesh.size(slot_axes)
    mine = biased[..., mesh.coord(slot_axes) * step:][..., :step]
    with use_mesh(mesh):
        ctx = _mla_blocked_shardmap(local, q, mine, prune,
                                    m.kv_lora_rank, scale_dim)
    return float((ctx - want).abs().max())


def mesh_moe(mesh, dev, rank):
    """grok-1-314b's MoE layer at full width (8 experts of d 6144 x ff
    32768, swiglu, top-2, capacity factor 8, f32 weights as the
    reference's test) through `transformer._moe` with moe_ep: 2 experts a
    rank, 4 x 64 tokens. Rank 0 also makes every expert and runs
    `apply_moe`; every rank's y is gathered there. Returns (the worst
    |d| over the ranks' y, the aux |d|) on rank 0, (None, None) elsewhere."""
    cfg = get_config("grok-1-314b")
    cfg = dataclasses.replace(cfg, moe_ep=True, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    mo, d, ff = cfg.moe, cfg.d_model, cfg.moe.d_ff_expert
    e_loc = mo.n_experts // mesh.shape["model"]
    gen = torch.Generator(device=dev)
    me = mesh.coord("model")
    mine = range(me * e_loc, (me + 1) * e_loc)
    every = range(mo.n_experts) if rank == 0 else mine
    # each expert from its own seed, drawn in place (rank 0: all 8, 19.3 GB)
    stack = {"wi": (d, ff), "wg": (d, ff), "wo": (ff, d)}
    stack = {k: torch.empty((len(every),) + shp, device=dev)
             for k, shp in stack.items()}
    for i, e in enumerate(every):
        gen.manual_seed(SEED + 100 + e)
        for k, w in stack.items():
            torch.randn(w.shape[1:], generator=gen, device=dev, out=w[i])
            w[i] /= math.sqrt(w.shape[1])
    gen.manual_seed(SEED + 99)
    router = torch.randn((d, mo.n_experts), generator=gen,
                         device=dev) / math.sqrt(d)
    x = torch.randn((LANES, 64, d), generator=gen, device=dev)
    local = {k: v[mine.start - every.start:][:e_loc] for k, v in
             stack.items()}
    with use_mesh(mesh):
        y, aux = transformer_mod._moe({"router": router, **local}, x, cfg)
    ys = all_gather(y, mesh.group("model"))
    if rank != 0:
        return None, None
    y_ref, aux_ref = moe_mod.apply_moe({"router": router, **stack}, x, cfg)
    return (float((ys - y_ref[None]).abs().max()),
            abs(float(aux) - float(aux_ref)))


def join_world(rank, world, store):
    """A spawned rank joins the world (NCCL with a card a rank, else gloo,
    `mesh_backend`) through the file store → (backend, its card, a
    function making a ProcessMesh ("data", "model") of a shape)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = mesh_backend()
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh_type = "cuda" if backend == "nccl" else "cpu"

    def mesh_of(shape):
        return ProcessMesh(init_device_mesh(mesh_type, shape,
                                            mesh_dim_names=("data",
                                                            "model")))
    return backend, dev, mesh_of


def leave_world(rank, out_dir, res):
    """Write the rank's results and leave the world."""
    import torch.distributed as dist
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_work(rank, world, backend, dev, mesh_of):
    """One rank's part of the [mesh] phase, in [slots]' world once its
    decode state is freed: the three collective paths on this rank's
    card → its results."""
    res = {"backend": backend, "device": str(dev)}
    m14 = mesh_of((1, world))
    t = time.monotonic()
    for kv, nb in MESH_RUNS:
        res[f"decode_{kv}_nb{nb}"] = mesh_decode(m14, dev, kv, nb)
    for kv in ("bf16", "int8"):
        res[f"latent_{kv}"] = mesh_latent(m14, dev, kv)
    res["decode_s"] = time.monotonic() - t
    t = time.monotonic()
    res["moe"] = mesh_moe(m14, dev, rank)
    res["moe_s"] = time.monotonic() - t
    return res


def spawn_ranks(fn: str, out: Path):
    """`chip_smoke.<fn>(rank, MESH_RANKS, store, out)` in MESH_RANKS fresh
    interpreters, whoever imported this module; every rank joined or
    killed. → each rank's `rank{r}.json`."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
         f"chip_smoke.{fn}({r}, {MESH_RANKS}, "
         f"{str(out / 'store')!r}, {str(out)!r})"], cwd=ROOT)
        for r in range(MESH_RANKS)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0] * MESH_RANKS, codes
    return [json.load(open(out / f"rank{r}.json"))
            for r in range(MESH_RANKS)]


def phase_mesh(ranks, smi):
    """The [mesh] phase: the MESH_RANKS ranks of [slots]' world (NCCL with
    a card each, else gloo sharing this card; `mesh_work`'s results in
    `ranks`) ran the slot-sharded decode at
    longchat-7b's full-width layer on the decode kernels' sharded route
    (bf16 and int8 KV, one block a rank and the global race: against the
    unsharded kernels and the sharded plain path, with no plain attention
    in the kernel route's steps), deepseek-v3's latent race at full width
    (against dense latent attention) and grok-1's MoE layer with moe_ep
    (against apply_moe), each within MESH_ATOL; the decode must evict in at
    least MESH_EVICTING_MIN steps. Prints the backend, the device of the
    collectives' operands, and every worst error. → (the sharded route's
    launches (every rank's), the worst out |d| against the unsharded
    kernels of each route's own runs)."""
    r0 = ranks[0]
    dec = {k: [r[k] for r in ranks] for k in r0 if k.startswith("decode_")
           and k != "decode_s"}
    operands = sorted({x["device"] for v in dec.values() for x in v})
    print(f"[mesh] {MESH_RANKS} ranks, backend {r0['backend']} on "
          f"{sorted({r['device'] for r in ranks})}; the collectives' "
          f"operands on {operands}  [{smi}]")
    launches = {"ragged_decode_shard": 0, "fused_decode_shard": 0}
    worst = dict.fromkeys(launches, 0.0)
    for kv, nb in MESH_RUNS:
        x = dec[f"decode_{kv}_nb{nb}"]
        key = "fused_decode_shard" if nb > 1 else "ragged_decode_shard"
        got = [r["launches"].get(key, 0) for r in x]
        launches[key] += sum(got)
        worst[key] = max(worst[key], *(r["vs_unsharded"] for r in x))
        print(f"  slot-sharded decode, longchat-7b layer (4 lanes x 32 "
              f"kv-heads, d 128, S 1088 = 4 x 272, select_k 128, "
              f"select_blocks {nb}), kv={kv}, {MESH_STEPS} steps from a "
              f"prefilled cache on the kernels' sharded route: out "
              f"max|d| {max(r['vs_unsharded'] for r in x):.3g} against "
              f"the unsharded kernels, {max(r['vs_plain'] for r in x):.3g}"
              f" against the sharded plain path (atol {MESH_ATOL}), acc "
              f"max|d| {max(r['acc'] for r in x):.3g}, valid/pos/fill/"
              f"step equal {all(r['same'] for r in x)}, evicting steps "
              f"{min(r['evicting'] for r in x)} (at least "
              f"{MESH_EVICTING_MIN}); {key} launches {got} a rank, plain "
              f"attention calls in its steps "
              f"{sum(r['plain_calls'] for r in x)}")
        assert all(g == MESH_STEPS for g in got), x
        assert not any(r["plain_calls"] for r in x), x
        assert max(r["vs_unsharded"] for r in x) <= MESH_ATOL, x
        assert max(r["vs_plain"] for r in x) <= MESH_ATOL, x
        assert max(r["acc"] for r in x) <= MESH_ATOL, x
        assert all(r["same"] for r in x), x
        assert min(r["evicting"] for r in x) >= MESH_EVICTING_MIN, x
    for kv in ("bf16", "int8"):
        lat = [r[f"latent_{kv}"] for r in ranks]
        print(f"  deepseek-v3 latent race (128 heads, latent 576, S 1088, 4 "
              f"blocks, full budget), kv={kv}, against dense latent "
              f"attention: ctx max|d| {max(lat):.3g} (atol {MESH_ATOL})")
        assert max(lat) <= MESH_ATOL, lat
    y_err, aux_err = r0["moe"]
    print(f"  grok-1-314b MoE layer with moe_ep (8 experts of 6144 x "
          f"32768 over 4 ranks, top-2, capacity factor 8, f32, 4 x 64 "
          f"tokens) against apply_moe: y max|d| {y_err:.3g} over every "
          f"rank's y (atol {MESH_ATOL}), aux |d| {aux_err:.3g}; decode and "
          f"latent checks {r0['decode_s']:.1f}s, MoE {r0['moe_s']:.1f}s a "
          f"rank")
    assert y_err <= MESH_ATOL and aux_err <= 1e-6, r0["moe"]
    return launches, worst


# ---------------------------------------------------------------------------
# the [slots] phase: long_500k over four ranks, the reference's layout
# ---------------------------------------------------------------------------

SLOTS_MESH = (2, 2)                # (data, model): heads and slots split
# [slots]' logits against [long]'s steps on the same state (granite-3-2b,
# 40 layers, bf16 compute): computed on one card as the ranks compute
# them (`laid_out_on_one_card`), and on the whole state, whose attention
# sums the slot blocks in another order; 40 layers of random weights carry
# that rounding to the logits. Each limit lies between the sound run's
# reading and the faults' (`slots_witness`; both in PERF.md): a fault on
# the last layer alone moves the logits by less than the whole state's
# distance, so only the first limit sees it
SLOTS_LAID_ATOL = 0.01
SLOTS_LOGIT_ATOL = 1.0


def gather_slots(cache, shard):
    """The whole slots of a slot-split one-layer block (every rank of
    `shard.group` gathers every field's blocks) → a whole KVCache of the
    block's batch rows and kv-heads."""
    from repro_torch.core.cache import KVCache
    from repro_torch.runtime.sharding import gather_blocks

    def whole(a):
        if a.dim() < 3:
            return a.clone()
        g = gather_blocks(a, shard)                      # [n, B, Hk, s, .]
        return torch.cat(list(g), dim=2)
    return KVCache(*(None if getattr(cache, f) is None else whole(
        getattr(cache, f)) for f in FIELDS))


def slots_rank(rank, world, store, out_dir):
    """One rank of the [slots] phase: granite-3-2b at full width and depth
    at long_500k (int8 K/V, one lane) on the (data 2 x model 2) mesh, its
    decode state laid out by `decode_state_pspecs` (4 of 8 kv-heads over
    `model`, 262,144 of 524,288 slots over `data`): every layer's block
    filled by `prefill_fill` from `[long]`'s seeded rows of its heads (no
    prompt pass), then `[long]`'s LONG_STEPS decode steps (its tokens,
    LONG_STEPS_FILE) through `Model.decode_step`: the logits, the launches
    by route and the step's host wall; layer 0's next step on a clone of
    its block, the kernels' sharded route against the unsharded long route
    over the gathered slots (winner sets, out, probs at scale); a step
    under torch.profiler (its kernel time); the peak memory. Then, its
    state freed, the rank's part of [mesh] (`mesh_work`) in the same
    world."""
    from repro_torch.core import attention as attention_mod
    backend, dev, mesh_of = join_world(rank, world, store)
    mesh = mesh_of(SLOTS_MESH)
    cfg = get_config("granite-3-2b")
    prune = long_prune("long_500k", "int8")
    model = Model(cfg, prune, device=dev)
    params = model.init(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.monotonic()
    layers, n, d = model.attn_layer_count(), prune.heavy_budget, cfg.head_dim
    layout = attention_mod.state_layout(
        mesh, (layers, 1, cfg.n_kv_heads, prune.slots, d))
    st = model._laid_out_state(1, layout)
    heads = range(layout.heads.offset, layout.heads.offset
                  + st.kv.k.shape[2])
    template = init_cache(1, len(heads), d, prune.slots, prune,
                          model.dtype, device=dev)
    for li in range(layers):
        k_rows, v_rows, acc = long_rows(li, heads, n, d)
        _store_layer(st, li, attention_mod.cut_cache(
            prefill_fill(template, k_rows, v_rows, acc, prune),
            attention_mod.Layout(None, None, layout.slots)))
        del k_rows, v_rows, acc
    del template
    torch.cuda.synchronize()
    fill_s = time.monotonic() - t
    saved = torch.load(LONG_STEPS_FILE)
    reset_launches()
    t = time.monotonic()
    steps = []
    for tok in saved["tokens"]:
        logits, st = model.decode_step(params, st, tok.view(1).to(dev))
        steps.append(logits)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t) / len(steps) * 1e3
    counts = {k: v for k, v in launch_counts().items() if v}
    logits = torch.cat(steps).float().cpu()

    # layer 0's next step on a clone of its block: the kernels' sharded
    # route against the unsharded long route over the gathered slots
    tok = torch.argmax(steps[-1], -1)
    p0 = layer_params(params["seg0_dense"], 0)
    h = L.apply_norm(p0["ln1"], model._embed(params, tok), cfg.norm)
    c = st.kv.layer(0).clone()
    q, k, v = decode_qkv(p0["attn"], h, cfg, c)
    write_token(c, k, v, prune)
    whole = gather_slots(c, c.shard)
    fills_w, args_w = cache_decode_args(whole, q, prune)
    out_w, probs_w = ragged_mod.ragged_decode(fills_w, *args_w,
                                              select_k=prune.select_k)
    _, idx_w = ref.decode_race(*args_w[1:5], args_w[7], args_w[8],
                               select_k=prune.select_k)
    fills_b, args_b = cache_decode_args(c, q, prune)
    stages = ragged_mod.ShardStages(
        "ragged_decode", ragged_mod.LAUNCHES, fills_b, *args_b,
        select_k=prune.select_k, offset=c.shard.offset)
    out_s, probs_s = ops.shard_route(stages, c.shard, prune.select_k, 1)
    same = torch.equal(torch.sort(stages.winners(), -1).values,
                       torch.sort(idx_w, -1).values)
    s0 = c.shard.offset
    mine = slice(s0, s0 + c.slots)
    live = ((args_w[7] != 0) & (torch.arange(prune.slots, device=dev)[None]
                                < fills_w[:, None]))
    g = cfg.n_heads // cfg.n_kv_heads
    e_scale, _ = probs_at_scale(probs_s, probs_w[:, mine], live[:, mine], g)
    # the block holds a part of each row's mass G: its sum against the
    # unsharded route's over the same slots
    e_sum = float((probs_s.double().sum(-1) - probs_w[:, mine].double()
                   .sum(-1)).abs().max()) / g
    res = {"backend": backend, "device": str(dev),
           "layout": [None if b is None else [b.offset, b.total]
                      for b in layout],
           "fill_s": fill_s, "wall_ms": wall, "launches": counts,
           "logits": logits.tolist() if rank == 0 else None,
           "worst_logit": float((logits - saved["logits"]).abs().max()),
           "step_logit": (logits - saved["logits"]).abs().amax(-1).tolist(),
           "worst_laid": float((logits - saved["laid"]).abs().max()),
           "layer0": {"winners_equal": same,
                      "out": float((out_s - out_w).abs().max()),
                      "probs": float((probs_s - probs_w[:, mine]).abs()
                                     .max()),
                      "probs_scale": e_scale, "probs_sum": e_sum}}
    del whole, args_w, out_w, probs_w, stages, c
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, st, tok)
        torch.cuda.synchronize()
    res["kernel_ms"] = sum(
        getattr(e, "self_device_time_total", 0.0)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA) / 1e3
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del st, model, params, p0, q, k, v, h, prof, steps, args_b, fills_b
    del out_s, probs_s, live
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    res["mesh"] = mesh_work(rank, world, backend, dev, mesh_of)
    res["mesh_s"] = time.monotonic() - t
    leave_world(rank, out_dir, res)


SHARD_SHAPES = (  # name, BH, G, d, S, slot ranks, select_k, K/V dtype
    ("granite-3-2b long_500k, a rank of (data 2 x model 2)", 4, 4, 64,
     524288, 2, LONG_K, torch.int8),
    ("longchat-7b layer over 4 ranks", 128, 1, 128, 1088, 4, 128,
     torch.bfloat16),
)


def shard_bound(fills, block, owned, cand_bytes):
    """(bound_ms, bound_by, bytes) of one rank's sharded route on its block
    (`block`: the eleven inputs over its S slots, `fills` its live counts
    [BH], `owned` [BH] the valid winners it holds): each row's live mirror
    rows with their scale and valid bytes, the prot row, the owned
    winners' K/V rows and scales, q, qq, qscale, the partials and probs,
    and `cand_bytes` of candidates read and written (the global race)."""
    q, qq, qscale, mirror, mscale, ks, vs, valid, prot, k, v = block
    bh, g, d = q.shape
    s, dv = mirror.shape[1], v.shape[-1]
    live = torch.clamp(fills.long(), 0, s).cpu().numpy()
    wins = owned.long().cpu().numpy()
    nbytes = int((g * d * 4 + g * d + g * 4 + 4 + s + g * (dv + 2) * 4
                  + s * 4 + live * (d + 4 + 1)
                  + wins * ((d + dv) * k.element_size() + 8)).sum()
                 + cand_bytes)
    t, by = bound(nbytes, float((2 * g * d * live).sum()),
                  float((2 * g * wins * (d + dv)).sum()))
    return t, by, nbytes


def merged_mz(stages):
    """The row's (max, sum) over every block's stages, merged as the
    collective merges them."""
    mz = torch.stack([x.mz() for x in stages]).double()
    top = mz[..., 0].amax(dim=0)
    z = torch.where(mz[..., 0] > -math.inf, mz[..., 1] * torch.exp(
        mz[..., 0] - top), torch.zeros_like(top)).sum(dim=0)
    return torch.stack([top, z], dim=-1).float()


def shard_times():
    """The sharded route's kernels on one rank's block (block 0 of the
    SHARD_SHAPES, the other blocks' candidates and statistics made once
    beforehand, so the collectives are not in the time), the global race
    (`ragged_decode_shard`) and one block a rank (`fused_decode_shard`):
    CUDA-event time of the four (three) stage launches, the plain stages'
    (`ref.ShardStagesRef` on the card) and the bound of the block's bytes
    (`shard_bound`). → {route: {shape: times}}."""
    times = {"ragged_decode_shard": {}, "fused_decode_shard": {}}
    for name, bh, g, d, s, n, k, kv in SHARD_SHAPES:
        fl = (long_fills(bh, s, k, 7) if s > 100000
              else MAIN_FILLS[:bh])
        fills, args = kernel_inputs(bh, g, d, s, fl, kv, seed=300)
        w = s // n
        blocks = [args[:3] + [a[:, i * w:(i + 1) * w].contiguous()
                              for a in args[3:]] for i in range(n)]
        for key, nb in (("ragged_decode_shard", 1), ("fused_decode_shard",
                                                     n)):
            mod = ragged_mod if nb == 1 else fused_mod

            def stages(i, plain):
                if plain:
                    return ref.ShardStagesRef(*blocks[i], offset=i * w)
                return ragged_mod.ShardStages(
                    key[:-6], mod.LAUNCHES, fills if nb == 1 else None,
                    *blocks[i], select_k=k, offset=i * w)
            pre = {}
            for plain in (False, True):
                sts = [stages(i, plain) for i in range(n)]
                for x in sts:
                    x.race(k if nb == 1 else k // n, final=nb > 1)
                gathered = (torch.stack([x.candidates() for x in sts])
                            if nb == 1 else None)
                if nb == 1:
                    for x in sts:
                        x.merge(gathered, k)
                pre[plain] = (gathered, merged_mz(sts), sts[0])

            def route(plain=False):
                gathered, mz, _ = pre[plain]
                x = stages(0, plain)
                if nb == 1:
                    x.race(k, final=False)
                    x.merge(gathered, k)
                    x.attend()
                else:
                    x.race(k // n, final=True)
                x.set_mz(mz)
                x.probs()
                return x.partials()
            ms = cuda_ms(route)
            plain_ms = cuda_ms(lambda: route(True), iters=3, warmup=1)
            first = pre[False][2]
            if nb == 1:
                picks = first.winners()
                fl0 = fills.clamp(0, w)
            else:
                kl = k // n
                picks = first._picks.view(-1)[:bh * kl].view(bh, kl).long()
                fl0 = torch.full_like(fills, w)
            ok = (picks >= 0) & (picks < w)
            ok &= torch.gather(blocks[0][7], 1, picks.clamp(0, w - 1)) != 0
            kc = min(k, w)
            cand = bh * (n * kc + kc) * 8 if nb == 1 else 0
            t, by, nbytes = shard_bound(fl0, blocks[0], ok.sum(-1), cand)
            times[key][name] = {"ms": ms, "plain_ms": plain_ms,
                                "bound_ms": t, "bound_by": by}
            print(f"  time {name} (BH={bh} G={g} d={d} S={s} over {n} "
                  f"ranks, {w} slots a rank, k={k} {str(kv)[6:]}) {key}: "
                  f"the block's kernels {ms:.4f} ms (collectives not "
                  f"included), plain {plain_ms:.4f} ms, bound {t:.4f} ms "
                  f"({by}: {nbytes} B at 3.35 TB/s); library call: none")
        del args, blocks
        torch.cuda.empty_cache()
    return times


def decode_32k_rank(rank, world, store, out_dir):
    """One rank of `decode_32k_over_cards`: longchat-7b at full width and
    depth, decode_32k's pruning with bf16 K/V, `greedy_generate` under
    `use_mesh` of (data 1 x model 4): the prompt pass replicated, each
    rank keeping its 8 of 32 kv-heads of every layer's cache, the decode
    steps on them with the outputs gathered. → its tokens, wall, peak
    memory and launches."""
    backend, dev, mesh_of = join_world(rank, world, store)
    mesh = mesh_of((1, world))
    cfg = get_config("longchat-7b")
    model = Model(cfg, long_prune("decode_32k", "bf16"), device=dev)
    params = model.init(SEED)
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        DECODE_32K_LANES, LONG_PROMPTS[0])), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    prompt = {}
    whole_prefill = model.prefill

    def prefill(*a, **kw):            # the prompt pass timed, then the
        t = time.monotonic()          # decode steps' launches counted
        out = whole_prefill(*a, **kw)
        torch.cuda.synchronize()
        prompt["s"] = time.monotonic() - t
        reset_launches()
        return out
    model.prefill = prefill
    with use_mesh(mesh):
        t = time.monotonic()
        toks, st = greedy_generate(model, params, {"tokens": tokens},
                                   LONG_NEW, device=dev)
        torch.cuda.synchronize()
        decode_s = time.monotonic() - t - prompt["s"]
    leave_world(rank, out_dir, {
        "backend": backend, "device": str(dev),
        "heads": list(st.kv.k.shape)[2], "tokens": toks.tolist(),
        "prompt_s": prompt["s"], "decode_s": decode_s,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "launches": {k: v for k, v in launch_counts().items() if v}})


DECODE_32K_LANES = 2


def decode_32k_over_cards():
    """longchat-7b at decode_32k with bf16 K/V on 2 lanes of 32,000-token
    prompts, 16 new tokens, through `greedy_generate` under a process
    mesh of (data 1 x model 4), 8 kv-heads a card (`decode_32k_rank`; run
    it with four cards: `PYTHONPATH=src python3 -c 'import chip_smoke as
    c; c.decode_32k_over_cards()'`): each card's peak memory, the decode
    tok/s, the prompt pass's wall and the launches by route; every rank's
    tokens equal."""
    smi = smi_line()
    assert torch.cuda.device_count() >= MESH_RANKS, "needs four cards"
    print(f"[build] {build.build_all(['ragged_decode', 'flash_prefill'])}")
    t = time.monotonic()
    ranks = spawn_ranks("decode_32k_rank", ROOT / "build" / "decode_32k")
    toks = [r["tokens"] for r in ranks]
    new = DECODE_32K_LANES * LONG_NEW
    print(f"[decode_32k over cards] longchat-7b decode_32k (S 32,768, "
          f"select_k 2,048, bf16 K/V), {DECODE_32K_LANES} lanes of "
          f"{LONG_PROMPTS[0]} tokens, {LONG_NEW} tokens each through "
          f"greedy_generate under (data 1 x model 4), backend "
          f"{ranks[0]['backend']} on {[r['device'] for r in ranks]}: "
          f"{ranks[0]['heads']} kv-heads a card; prompt pass "
          f"{max(r['prompt_s'] for r in ranks):.2f}s; decode "
          f"{new / max(r['decode_s'] for r in ranks):.2f} tok/s ({new} "
          f"tokens: {LONG_NEW} decode steps a lane); peak "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB a card; "
          f"launches a card {[r['launches'] for r in ranks]}; the ranks' "
          f"tokens equal {all(x == toks[0] for x in toks)}; "
          f"{time.monotonic() - t:.1f}s  [{smi}]")
    assert all(x == toks[0] for x in toks)


def near_tie(row, limit) -> bool:
    """Whether a logits row's top two lie within twice `limit`: logits
    held within `limit` of it can swap them."""
    top = torch.topk(row, 2).values
    return float(top[0] - top[1]) <= 2 * limit


def phase_slots(smi):
    """The [slots] phase: MESH_RANKS spawned ranks (`slots_rank`) decode
    granite-3-2b's long_500k state laid out over (data 2 x model 2) by the
    reference's rules, a cache no rank holds whole, through
    `Model.decode_step` on the decode kernels' sharded route, against
    `[long]`'s unsharded steps on the same state: the logits within
    SLOTS_LAID_ATOL of its steps computed on one card as the ranks
    compute them and within SLOTS_LOGIT_ATOL of its whole state's; each
    step's greedy argmax equal to both but at a near-tie (`near_tie` of
    the unsharded step and the limit, printed as such);
    layer 0's winner sets equal,
    its out within OUT_ATOL and its probs at scale (PROBS_RTOL,
    PROBS_SUM_RTOL). Prints the launches by route, each rank's peak
    memory, a step's wall and kernel time. → ({route: launches}, layer 0's
    worst error, each rank's [mesh] results and the seconds they took)."""
    t0 = time.monotonic()
    gc.collect()                      # the card's memory to the ranks
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_reserved() / 2 ** 30
    print(f"[slots] this process holds {held:.2f} GiB; "
          f"{free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB free on the "
          f"card before the ranks start")
    ranks = spawn_ranks("slots_rank", ROOT / "build" / "slots_phase")
    r0 = ranks[0]
    saved = torch.load(LONG_STEPS_FILE)
    worst = max(r["worst_logit"] for r in ranks)
    worst_laid = max(r["worst_laid"] for r in ranks)
    got = torch.tensor(r0["logits"])
    ties, wrong = [], []
    for key, limit in (("laid", SLOTS_LAID_ATOL),
                       ("logits", SLOTS_LOGIT_ATOL)):
        for i, (a, b) in enumerate(zip(got, saved[key])):
            if int(a.argmax()) != int(b.argmax()):
                (ties if near_tie(b, limit) else wrong).append((key, i))
    counts = {}
    for r in ranks:
        for k, n in r["launches"].items():
            counts[k] = counts.get(k, 0) + n
    layers = get_config("granite-3-2b").num_layers
    print(f"[slots] granite-3-2b long_500k (S 524,288, select_k 2,048, "
          f"int8 K/V, batch 1) over {MESH_RANKS} ranks (data 2 x model 2), "
          f"backend {r0['backend']}: layout rows/heads/slots "
          f"{r0['layout']} (rank 0), blocks filled in "
          f"{max(r['fill_s'] for r in ranks):.1f}s; {len(got)} decode steps "
          f"against [long]'s unsharded ones: logits max|d| "
          f"{worst_laid:.4g} against its steps computed as the ranks do "
          f"(atol {SLOTS_LAID_ATOL}), {worst:.4g} against the whole state's "
          f"(atol {SLOTS_LOGIT_ATOL}; a step: "
          f"{[round(x, 4) for x in r0['step_logit']]}); greedy argmax "
          f"parted at {ties + wrong} (near-ties {ties}) of {len(got)} "
          f"steps each; launches by route over the ranks "
          f"{counts}; a step {max(r['wall_ms'] for r in ranks):.1f} ms host "
          f"wall, {max(r['kernel_ms'] for r in ranks):.2f} ms of kernel "
          f"time a rank (torch.profiler, one more step); peak "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB a rank  [{smi}]")
    l0 = [r["layer0"] for r in ranks]
    print(f"  layer 0's next step, the kernels' sharded route against the "
          f"unsharded long route over the gathered slots: winner sets equal "
          f"{all(x['winners_equal'] for x in l0)}, out max|d| "
          f"{max(x['out'] for x in l0):.3g} (atol {OUT_ATOL}), probs max|d| "
          f"{max(x['probs'] for x in l0):.3g}, at scale "
          f"{max(x['probs_scale'] for x in l0):.3g} (row sums "
          f"{max(x['probs_sum'] for x in l0):.3g})")
    assert not wrong, (wrong, worst, worst_laid)
    assert worst_laid <= SLOTS_LAID_ATOL, worst_laid
    assert worst <= SLOTS_LOGIT_ATOL, worst
    assert counts.get("ragged_decode_shard", 0) == MESH_RANKS * layers * len(
        got), counts
    assert all(x["winners_equal"] for x in l0), l0
    assert max(x["out"] for x in l0) <= OUT_ATOL, l0
    assert max(x["probs_scale"] for x in l0) <= PROBS_RTOL, l0
    assert max(x["probs_sum"] for x in l0) <= PROBS_SUM_RTOL, l0
    mesh_s = max(r["mesh_s"] for r in ranks)
    print(f"[slots] phase {time.monotonic() - t0 - mesh_s:.1f}s (the "
          f"world's [mesh] part {mesh_s:.1f}s apart)")
    return ({"ragged_decode_shard": counts["ragged_decode_shard"]},
            max(max(x["out"] for x in l0), max(x["probs"] for x in l0)),
            [r["mesh"] for r in ranks], mesh_s)


SLOTS_FAULTS = ("qkv", "gather", "gather_last")


def slots_witness():
    """What [slots]' two limits can see, on one card (`PYTHONPATH=src
    python3 -c 'import chip_smoke as c; c.slots_witness()'`): [long]'s
    long_500k phase (its steps on the whole state and computed as the
    ranks compute them), then each fault of `laid_out_on_one_card` on the
    same state and tokens: the fault's logits max|d| against both sets
    of steps and the steps whose greedy argmax parts; then [slots] itself
    (the sound run's readings, held to the limits) and [mesh] in its
    world. A fault read above a limit is one [slots] fails on."""
    smi = smi_line()
    secs = build.build_all(["ragged_decode", "fused_decode", "approx_score",
                            "gather_attention"])
    print(f"[build] {secs}")
    phase_long_500k(smi)
    cfg = get_config("granite-3-2b")
    prune = long_prune("long_500k", "int8")
    model = Model(cfg, prune, device="cuda")
    params = model.init(SEED)
    saved = torch.load(LONG_STEPS_FILE)
    for fault in SLOTS_FAULTS:
        with laid_out_on_one_card(SLOTS_MESH[1], SLOTS_MESH[0],
                                  model.attn_layer_count(), fault):
            got = teacher_logits(model, params,
                                 long_state(model, cfg, prune),
                                 saved["tokens"])
        parted = {k: torch.nonzero(got.argmax(-1) != saved[k].argmax(-1))
                  .view(-1).tolist() for k in ("laid", "logits")}
        print(f"[slots witness] fault {fault!r}: logits max|d| "
              f"{float((got - saved['laid']).abs().max()):.4g} against "
              f"the sound run computed so (atol {SLOTS_LAID_ATOL}), "
              f"{float((got - saved['logits']).abs().max()):.4g} against "
              f"the whole state's (atol {SLOTS_LOGIT_ATOL}); greedy "
              f"argmax parted at steps {parted}  [{smi}]")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    _, _, mesh_ranks, _ = phase_slots(smi)
    phase_mesh(mesh_ranks, smi)


# ---------------------------------------------------------------------------
# phase 9: the rest of the dense family and the MoE family, full width
# ---------------------------------------------------------------------------

VISION_PROMPT, VISION_STEPS = 1024, 16   # llava: 4 prompts, 16 steps
GROK_LAYERS = 4                          # grok-1-314b's depth, cut to fit
FAMILY_PRUNE = dict(heavy=PROMPT_LEN // 2, reserve=64,
                    select_k=PROMPT_LEN // 16)


def family_weights(name, smi, **cut):
    """A full-width config (`cut`: the fields cut to fit the card) and its
    random bf16 weights from SEED, made on the card."""
    cfg = get_config(name)
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    params = Model(cfg, baselines.unicaim(**FAMILY_PRUNE),
                   device="cuda").init(SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    heads = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads: G = "
             f"{cfg.n_heads // cfg.n_kv_heads}" if cfg.n_kv_heads
             else "no attention")
    print(f"[family] {name} ({cfg.family}, {cfg.num_layers} layers"
          f"{' cut from ' + str(get_config(name).num_layers) if cut else ''}"
          f", d {cfg.d_model}, {heads},"
          f" norm {cfg.norm}, act {cfg.act}, qkv_bias {cfg.qkv_bias}, "
          f"frontend {cfg.frontend}): {n_params} random bf16 params, made "
          f"on the card in {time.monotonic() - t:.1f}s  [{smi}]")
    return cfg, params


def family_done(name, t0, smi):
    print(f"[family] {name} done in {time.monotonic() - t0:.1f}s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)  [{smi}]")


def phase_vision(cfg, params, smi):
    """llava's frontend stub through `greedy_generate`: four 1,024-token
    prompts behind a seeded [4, 576, d] vision_embed; every lane's cache
    holds 576 + its length positions after the prefill; the prompt pass
    runs flash_prefill once a layer, each decode step ragged_decode once a
    layer, and nothing else."""
    model = Model(cfg, baselines.unicaim(fused=True, kv_dtype="bf16",
                                         **FAMILY_PRUNE), device="cuda")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    length = torch.full((LANES,), VISION_PROMPT, dtype=torch.int32,
                        device="cuda")
    batch = {"tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (LANES, VISION_PROMPT)), device="cuda"),
             "length": length,
             "vision_embed": torch.randn(
                 (LANES, cfg.frontend_len, cfg.d_model), generator=gen,
                 device="cuda")}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, st = model.prefill(params, batch)
    torch.cuda.synchronize()
    ttft = time.monotonic() - t0
    steps = st.kv.step
    assert torch.equal(steps, (cfg.frontend_len + length).expand_as(steps)), \
        steps
    assert torch.isfinite(logits).all()
    del st
    reset_launches()
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0
    t0 = time.monotonic()
    toks, st = greedy_generate(model, params, batch, VISION_STEPS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    ragged, flash = counts.pop("ragged_decode"), counts.pop("flash_prefill")
    print(f"  greedy_generate {cfg.name}: {LANES} prompts of "
          f"{VISION_PROMPT} tokens behind {cfg.frontend_len} vision rows, "
          f"cache.step after the prefill {cfg.frontend_len} + "
          f"{VISION_PROMPT} on every lane and layer; a prefill (TTFT) "
          f"{ttft:.3f}s; prefill + {VISION_STEPS} steps in {wall:.3f}s = "
          f"{LANES * VISION_STEPS / wall:.1f} tok/s; ragged_decode launches "
          f"{ragged} = {cfg.num_layers} x {VISION_STEPS}, flash_prefill "
          f"{flash} = {cfg.num_layers} x 1; plain prompt attention on the "
          f"card {PLAIN_ON_CARD}; other kernels {counts}  [{smi}]")
    assert toks.shape == (LANES, VISION_STEPS)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert torch.equal(st.kv.step, (cfg.frontend_len + length
                                    + VISION_STEPS).expand_as(st.kv.step))
    assert ragged == cfg.num_layers * VISION_STEPS
    assert flash == cfg.num_layers
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    assert not any(counts.values()), counts
    return {"ragged_decode": ragged, "flash_prefill": flash}


def print_drops(tag, drops, cfg):
    """The (token, choice) pairs each prompt pass lost to the experts'
    capacity, summed over its MoE layers; decode steps (LANES tokens, at
    most 8 an expert: under the least capacity) must lose none."""
    layers, k = cfg.num_layers - cfg.moe.dense_first_k, cfg.moe.top_k
    passes = [(n, int(d)) for n, d in drops if n > LANES]
    assert not any(int(d) for n, d in drops if n <= LANES)
    assert len(passes) % layers == 0, len(passes)
    rows = [(passes[i][0], sum(d for _, d in passes[i:i + layers]))
            for i in range(0, len(passes), layers)]
    print(f"  {tag}: per prompt pass, (its tokens, the (token, choice) pairs "
          f"the experts' capacity dropped over its {layers} layers, of "
          f"tokens x {k} x {layers}): {rows}")


def phase_family(smi):
    """Phase 9: starcoder2-3b (LayerNorm, tanh-GELU, qkv bias, G = 12),
    minitron-8b (LayerNorm, relu², vocab 256,000), phi3-medium-14b (40
    layers), llava-next-mistral-7b (the vision frontend) at full width and
    depth, and grok-1-314b (MoE, 8 experts of d_ff 32,768) at full width,
    its depth cut to GROK_LAYERS. Returns the launches of each kernel."""
    launches = dict.fromkeys(launch_counts(), 0)

    def serve(cfg, params, kv, blocks=1, chunk=0, **kw):
        kernel, n, flash, model, handles, _ = phase_serve(
            cfg, params, kv, smi, blocks, chunk=chunk, **kw)
        launches[kernel] += n
        launches["flash_prefill"] += flash
        return model, handles

    def starcoder2():
        cfg, params = family_weights("starcoder2-3b", smi)
        for blocks, kv in itertools.product((1, 4), ("bf16", "int8")):
            if (blocks == 1) == (kv == "bf16"):
                model, whole = serve(cfg, params, kv, blocks)
            else:       # cut to 4 requests of half the new tokens
                serve(cfg, params, kv, blocks, n=LANES, new=NEW_TOKENS // 2)
            if blocks == 1 and kv == "bf16":
                phase_teacher(cfg, params, model)
                # cut to 4 requests of half the new tokens
                cmodel, sliced = serve(cfg, params, kv, 1, chunk=CHUNK,
                                       n=LANES, new=NEW_TOKENS // 2)
                phase_chunked(cfg, params, cmodel, whole, sliced, CHUNK,
                              n=LANES)

    def minitron():
        cfg, params = family_weights("minitron-8b", smi)
        serve(cfg, params, "bf16")

    def phi3():
        cfg, params = family_weights("phi3-medium-14b", smi)
        serve(cfg, params, "bf16", n=LANES, new=NEW_TOKENS // 2)

    def llava():
        cfg, params = family_weights("llava-next-mistral-7b", smi)
        for name, n in phase_vision(cfg, params, smi).items():
            launches[name] += n

    def grok():
        cfg, params = family_weights("grok-1-314b", smi,
                                     num_layers=GROK_LAYERS)
        for kv, chunk in (("bf16", 0), ("int8", 0), ("bf16", CHUNK)):
            moe_mod.DROPS = []
            try:
                serve(cfg, params, kv, chunk=chunk)
                print_drops(f"{cfg.name} kv={kv} chunk_prefill={chunk}",
                            moe_mod.DROPS, cfg)
            finally:
                moe_mod.DROPS = None

    for name, run in (("starcoder2-3b", starcoder2),
                      ("minitron-8b", minitron),
                      ("phi3-medium-14b", phi3),
                      ("llava-next-mistral-7b", llava),
                      ("grok-1-314b", grok)):
        t0 = time.monotonic()
        run()
        family_done(name, t0, smi)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: MLA latent attention and the mla_moe family (deepseek-v3-671b)
# ---------------------------------------------------------------------------

MLA_LAYERS = 5        # deepseek-v3-671b's 61 layers cut to 3 mla_dense + 2
#                       mla_moe: the MoE segment keeps a stacked axis


def plain_prefill_attention(q, k, v, acc=None, *, row0=0, length=None,
                            obs_window=0, chunk=512, scale=None):
    """ops.prefill_attention's plain version (with the latent route's
    f64 denominators), run on the card: the check's other prompt pass
    (never the served path). 128 query rows at a time, so its [B, 128,
    rows, N] f64 denominator sums fit beside the model."""
    out, col = ref.prefill_attention_ref(q, k, v, row0=row0, length=length,
                                         obs_window=obs_window,
                                         chunk=min(chunk, 128), scale=scale,
                                         den_f64=True)
    if acc is None:
        return out, col
    acc += col
    return out, acc


def mla_serve(cfg, params, kv, smi, chunk=0, **knobs):
    """Serve phase 4's 8 requests through the mla_moe model: every prompt
    pass runs flash_prefill's latent route once a layer, no decode kernel
    launches (MLA decode is plain PyTorch, as the reference's is plain
    XLA), no plain prompt attention runs on the card, and chunk_prefill
    admits whole prompts. Returns (flash_prefill launches, the streams,
    the model)."""
    prune = baselines.unicaim(kv_dtype=kv, **FAMILY_PRUNE, **knobs)
    model = Model(cfg, prune, device="cuda")
    loop = ServeLoop(model, params, lanes=LANES, max_new=NEW_TOKENS, block=8,
                     chunk_prefill=chunk, device="cuda")
    prompts = served_prompts(cfg.vocab_size)
    handles = [(loop.submit(Request(prompt=p, max_new=m)), m)
               for p, m in prompts]
    torch.cuda.synchronize()
    reset_launches()
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0
    moe_mod.DROPS = []
    try:
        t0 = time.monotonic()
        stats = loop.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        drops = moe_mod.DROPS
    finally:
        moe_mod.DROPS = None
    counts = launch_counts()
    flash = counts.pop("flash_prefill")
    c = loop.counters
    toks = sum(len(st.tokens) for st in stats)
    agg = loop.aggregate()
    tag = (f"kv={kv} chunk_prefill={chunk} "
           + " ".join(f"{k}={v}" for k, v in knobs.items()))
    print(f"  serve {cfg.name} {tag}: {len(stats)} requests on {LANES} "
          f"lanes, {toks} tokens in {wall:.3f}s = {toks / wall:.1f} tok/s, "
          f"p50 TTFT {agg['p50_ttft_s']:.3f}s; {c['decode_steps']} decode "
          f"steps, {c['prefill_dispatches']} prefills, "
          f"{c['chunk_dispatches']} chunk dispatches, "
          f"{c['grouped_requests']} requests group-admitted; flash_prefill "
          f"(latent route) launches {flash} = {cfg.num_layers} x "
          f"{c['prefill_dispatches']}: "
          f"{flash == cfg.num_layers * c['prefill_dispatches']}; decode "
          f"kernels and the rest {counts}; plain prompt attention on the "
          f"card {PLAIN_ON_CARD}  [{smi}]")
    assert all(h.done and len(h.tokens) == m for h, m in handles)
    assert c["nonfinite_lanes"] == 0 and c["chunk_dispatches"] == 0
    assert flash == cfg.num_layers * c["prefill_dispatches"] and flash > 0
    assert not any(counts.values()), counts
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    print_drops(f"{cfg.name} {tag}", drops, cfg)
    return flash, [h.tokens for h, _ in handles], model


def prompt_teacher(cfg, params, model, steps=16, batch=None):
    """`batch` (by default the 4 served prompts in the 4 x 2048 bucket)
    through the kernel's prompt pass and through the plain version on the
    card (a check only): the share of each cache layer's kept positions the
    two passes agree on (the worst lane and kv-head), then `steps` decode
    steps from each state fed the same tokens (the kernel side's greedy
    choices), the top-1 agreement over steps x LANES and the plain side's
    top-2 gap where they part. Returns (the worst layer's kept share, the
    top-1 agreement, a decode step's wall in ms: host clock around a
    synchronised step)."""
    batch = batch or served_batch(cfg)
    served = ops.prefill_attention

    def prefill(attend):
        ops.prefill_attention = attend
        try:
            return model.prefill(params, batch)
        finally:
            ops.prefill_attention = served

    logits, st = prefill(served)
    logits_p, st_p = prefill(plain_prefill_attention)
    kept = []
    for li in range(model.attn_layer_count()):
        pk, pp = st.kv.pos[li], st_p.kv.pos[li]              # [B, Hk, S]
        kept.append(min(
            int(torch.isin(pk[b, h][pk[b, h] >= 0],
                           pp[b, h][pp[b, h] >= 0]).sum())
            / int((pk[b, h] >= 0).sum())
            for b in range(LANES) for h in range(pk.shape[1])))
    first = float((logits - logits_p).abs().max())
    tok = torch.argmax(logits, -1)
    agree, worst, walls, gaps = 0, 0.0, [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        lk, st = model.decode_step(params, st, tok)
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
        lp, st_p = model.decode_step(params, st_p, tok)
        worst = max(worst, float((lk - lp).abs().max()))
        ak, ap = torch.argmax(lk, -1), torch.argmax(lp, -1)
        agree += int((ak == ap).sum())
        top2 = torch.topk(lp, 2, dim=-1).values
        gaps += [round(float(x), 3) for x in (top2[:, 0] - top2[:, 1])[
            ak != ap]]
        tok = ak
    step_ms = float(np.median(walls))
    print(f"  teacher-forced {cfg.name}, {cfg.num_layers} layers, policy "
          f"{model.prune.policy}, kv={model.prune.kv_dtype}: the prompt pass "
          f"through flash_prefill vs the plain version (f64 denominators) on "
          f"the "
          f"card: "
          f"kept positions agree on {[round(k, 5) for k in kept]} (worst "
          f"lane and kv-head, by cache layer), first-token logits max|d| "
          f"{first:.3g}; "
          f"{steps} steps x {LANES} lanes fed the same tokens: logits "
          f"max|d| {worst:.3g}, top-1 equal in {agree} of {steps * LANES}; "
          f"the plain side's top-2 gap where they part {sorted(gaps)}; a "
          f"decode step's wall {step_ms:.2f} ms (median of {steps}, "
          f"synchronised)")
    assert math.isfinite(first) and math.isfinite(worst)
    return min(kept), agree, step_ms


def mla_latent_survey(cfg, params, model):
    """The latent route on phase 10's own inputs: one 4 x 2048 prompt pass
    of the served prompts with ops.prefill_attention watched, the exact
    rows of each layer's absorbed q and latent u (`exact_rows`); then on
    layer 0's inputs the route's time as served and with EXACT_BELOW = 0,
    and the plain version's (f64 denominators) on the same inputs.
    Returns those numbers."""
    served = ops.prefill_attention
    counts, held = [], {}

    def watch(q, k, v, acc=None, **kw):
        counts.append(exact_rows(q, k, LATENT_SCALE))
        if not held:
            held.update(q=q.to(k.dtype).contiguous(), u=k.contiguous(), kw=kw)
        return served(q, k, v, acc, **kw)

    ops.prefill_attention = watch
    try:
        model.prefill(params, served_batch(cfg))
    finally:
        ops.prefill_attention = served
    torch.cuda.synchronize()
    q, u, kw = held["q"], held["u"], held["kw"]
    v = u[..., :flash_mod.LATENT[1]]
    assert q.shape == (LANES, LATENT_HEADS, PROMPT_LEN, flash_mod.LATENT[0])
    assert kw.get("row0", 0) == 0 and kw["scale"] == LATENT_SCALE, kw
    ln = kw["length"].to(torch.int32)
    obs = kw.get("obs_window", 0)
    ms, ms_tc = latent_route_ms(q, u, v, ln, obs)
    plain = long_ms(lambda: ref.prefill_attention_ref(
        q, u, v, length=ln, obs_window=obs, scale=LATENT_SCALE,
        den_f64=True))
    share = [round(c / n, 5) for c, n in counts]
    print(f"  latent route on phase 10's inputs ({cfg.name}, "
          f"{cfg.num_layers} layers, the served prompts, lengths "
          f"{ln.tolist()}): exact rows (largest probability above "
          f"1/{flash_mod.EXACT_BELOW:g}) by layer {[c for c, _ in counts]} "
          f"of {counts[0][1]} ({share}); layer 0's inputs: kernel pair "
          f"{ms:.4f} ms, with EXACT_BELOW = 0 {ms_tc:.4f} ms, plain (f64 "
          f"denominators) {plain:.4f} ms")
    del held, q, u, v
    return {"exact_rows_by_layer": [c for c, _ in counts],
            "rows": counts[0][1], "layer0_ms": ms,
            "layer0_no_exact_rows_ms": ms_tc, "layer0_plain_ms": plain}


def phase_mla(smi):
    """Phase 10: deepseek-v3-671b at full width (d 7168, 128 heads, latent
    576, 256 experts of d_ff 2048 and a shared one, dense blocks of d_ff
    18,432, the MTP head), its depth cut to MLA_LAYERS, random bf16
    weights from the seed made on the card. Served bf16 with global
    selection, select_blocks 4, the threshold race and chunk_prefill 512
    (the reference's latent attend ignores the first three without a mesh,
    and an MLA model admits whole prompts: every stream must equal the
    first run's), int8 with global selection and select_blocks 4 (equal
    streams). The kernel's prompt pass against the plain one: under the
    served pruning every layer keeps the same positions (at least
    KEPT_MIN of them, both KV dtypes), and with the dense policy (exact
    decode over every prompt row) 16 teacher-forced steps agree on top-1
    at least TEACHER_AGREE_MIN of 64 times. Under the served pruning the
    teacher-forced agreement is printed, not held: its 4-bit CAM scores
    and top-128 race turn logit noise into other winners (`PERF.md` §6).
    One 4 x 2048 prompt pass profiled. Returns the launches of each
    kernel."""
    t_all = time.monotonic()
    cfg, params = family_weights("deepseek-v3-671b", smi,
                                 num_layers=MLA_LAYERS)
    launches = dict.fromkeys(launch_counts(), 0)
    for kv, runs in (("bf16", ({}, {"select_blocks": 4},
                               {"select_mode": "threshold"},
                               {"chunk": CHUNK})),
                     ("int8", ({}, {"select_blocks": 4}))):
        first = None
        for knobs in runs:
            t = time.monotonic()
            flash, streams, model = mla_serve(cfg, params, kv, smi, **knobs)
            launches["flash_prefill"] += flash
            same = first is None or streams == first
            print(f"[mla] kv={kv} {knobs or 'select_blocks=1'}: streams equal "
                  f"the select_blocks=1 run's {same}; "
                  f"{time.monotonic() - t:.1f}s")
            assert same, knobs
            if first is None:
                first = streams
                t = time.monotonic()
                kept, _, step_ms = prompt_teacher(cfg, params, model)
                assert kept >= KEPT_MIN, (kept, KEPT_MIN)
                if kv == "bf16":
                    phase_prefill_profile(cfg, params, model)
                    survey = mla_latent_survey(cfg, params, model)
                print(f"[mla] kv={kv} teacher-forced and profile "
                      f"{time.monotonic() - t:.1f}s")
            del model
    t = time.monotonic()
    exact = Model(cfg, baselines.dense(PROMPT_LEN + 64), device="cuda")
    _, agree, _ = prompt_teacher(cfg, params, exact)
    assert agree >= TEACHER_AGREE_MIN, (agree, TEACHER_AGREE_MIN)
    print(f"[mla] dense-policy teacher-forced {time.monotonic() - t:.1f}s")
    del exact
    family_done("deepseek-v3-671b", t_all, smi)
    print(f"[mla] phase 10 {time.monotonic() - t_all:.1f}s; a served decode "
          f"step's wall {step_ms:.2f} ms (int8, the last measured)")
    return launches, survey


# ---------------------------------------------------------------------------
# phase 11: Mamba2 SSD blocks, the ssm (mamba2-1.3b) and hybrid (zamba2-7b)
# families
# ---------------------------------------------------------------------------

# prefill -> decode continuity of mamba2-1.3b on the card: the decode of
# token t against the prompt pass over t + 1 tokens, bf16 activations
# through 48 blocks in two orders (the chunked scan against the
# recurrence): logits within this of each other, the same top-1
CONT_ATOL = 0.125


def recurrent_batch(cfg, n=PROMPT_LEN):
    """LANES prompts of `n` tokens from the seed, every row at full length
    (a recurrent model takes no length mask)."""
    rng = np.random.default_rng(SEED + 11)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (LANES, n)),
                                      device="cuda")}


def ssm_continuity(cfg, params, model):
    """A 4 x 2048 prompt pass then the decode of token 2048 against the
    prompt pass over all 2049 tokens: logits within CONT_ATOL, the same
    top-1 on every lane."""
    toks = recurrent_batch(cfg, PROMPT_LEN + 1)["tokens"]
    _, st = model.prefill(params, {"tokens": toks[:, :PROMPT_LEN]})
    step, _ = model.decode_step(params, st, toks[:, PROMPT_LEN])
    whole, _ = model.prefill(params, {"tokens": toks})
    err = float((step - whole).abs().max())
    same = torch.equal(torch.argmax(step, -1), torch.argmax(whole, -1))
    top2 = torch.topk(whole, 2, dim=-1).values
    print(f"  continuity {cfg.name}: {LANES} x {PROMPT_LEN} prompt pass + "
          f"decode of token {PROMPT_LEN} vs the prompt pass over "
          f"{PROMPT_LEN + 1} tokens: logits max|d| {err:.4g} (atol "
          f"{CONT_ATOL}, max|logit| {float(whole.abs().max()):.3g}), top-1 "
          f"equal on every lane {same} (top-2 gaps "
          f"{[round(float(g), 4) for g in top2[:, 0] - top2[:, 1]]})")
    assert torch.isfinite(step).all() and torch.isfinite(whole).all()
    assert err <= CONT_ATOL and same, (err, same)


def part_prefill_profile(cfg, params, model, batch, owner, attr, label,
                         calls):
    """Where one 4 x 2048 prompt pass spends its time: host wall (no
    profiler); the device time of its kernels under torch.profiler and the
    flash_prefill pair's share; then, in another pass, CUDA events around
    every call of `owner.attr` (the SSD blocks' `ssm_prefill`, or an
    enc-dec model's `_encode`), `calls` of them, whose sum over the wall is
    that part's (`label`) share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        model.prefill(params, batch)
        torch.cuda.synchronize()

    run()                                                # warm
    t0 = time.monotonic()
    run()
    wall = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    flash = sum(dev_us(e) for e in kernels
                if "flash_prefill" in e.key or "fold_columns" in e.key) / 1e3
    events = []
    served = getattr(owner, attr)
    own = attr in vars(owner)       # a module's function, not a method

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = served(*args, **kw)
        end.record()
        events.append((start, end))
        return y

    setattr(owner, attr, timed)
    try:
        t0 = time.monotonic()
        run()
        wall_ev = (time.monotonic() - t0) * 1e3
    finally:
        if own:
            setattr(owner, attr, served)
        else:
            delattr(owner, attr)
    part_ms = sum(a.elapsed_time(b) for a, b in events)
    share = ("not measured" if busy == 0 else
             f"{busy / wall:.1%} busy, flash_prefill pair {flash:.2f} ms = "
             f"{flash / busy:.1%} of the kernel time")
    print(f"  profile prompt pass {cfg.name} policy={model.prune.policy} "
          f"kv={model.prune.kv_dtype} B={LANES} N={PROMPT_LEN}: {wall:.2f} ms "
          f"host wall, {busy:.2f} ms of kernel time ({share}), "
          f"{sum(e.count for e in kernels)} kernel launches; the "
          f"{label} ({len(events)} calls) {part_ms:.2f} ms between CUDA "
          f"events = {part_ms / wall_ev:.1%} of that pass's {wall_ev:.2f} ms "
          "wall")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:80]}")
    assert len(events) == calls, (len(events), calls)


def recurrent_prefix_splice(cfg, params, model, smi):
    """The prefix cache's exact hit for a recurrent model: one 2048-token
    request, then the same prompt again; the repeat splices the cached
    state (its SSM state, and the hybrid's pruned caches) with no prefill
    and reproduces the stream. Printed: the splice's host wall and the
    entry's state bytes, cache and SSM state apart. Returns the launches."""
    loop = ServeLoop(model, params, lanes=LANES, max_new=NEW_TOKENS, block=8,
                     prefix_cache_bytes=PREFIX_BUDGET, device="cuda")
    prompt = served_prompts(cfg.vocab_size)[0][0]
    torch.cuda.synchronize()
    reset_launches()
    first = loop.submit(Request(prompt=prompt, max_new=NEW_TOKENS // 2))
    loop.run()
    again = loop.submit(Request(prompt=prompt, max_new=NEW_TOKENS // 2))
    loop.run()
    torch.cuda.synchronize()
    counts = launch_counts()
    c = loop.counters
    entry = loop.prefix_cache.match_state(prompt)
    kv_b, ssm_b = _tree_nbytes(entry.state.kv), _tree_nbytes(entry.state.ssm)
    splice_ms, insert_ms = (1e3 * loop.prefix_host_s[k]
                            for k in ("splice_s", "insert_s"))
    print(f"  prefix cache {cfg.name}: a repeated {len(prompt)}-token prompt "
          f"is an exact hit {c['prefix_exact_hits']} (prefills "
          f"{c['prefill_dispatches']}), its stream equals the first's "
          f"{again.tokens == first.tokens}; the splice {splice_ms:.3f} ms "
          f"host wall, the entry {entry.nbytes} B (cache {kv_b} B, SSM state "
          f"{ssm_b} B, logits {entry.nbytes - kv_b - ssm_b} B); the "
          f"snapshot copy {insert_ms:.3f} ms  [{smi}]")
    assert c["prefix_exact_hits"] == 1 and c["prefill_dispatches"] == 1
    assert again.tokens == first.tokens and len(first.tokens) > 0
    assert ssm_b > 0
    return counts


def phase_ssm(smi):
    """Phase 11: mamba2-1.3b (48 SSD blocks, full) served under the dense
    policy twice (equal streams, no kernel launches), its prefill->decode
    continuity, a decode step and a 4 x 2048 prompt pass profiled, a
    prefix-cache exact hit; then zamba2-7b (81 SSD blocks and 13
    applications of one shared attention block, full) served under unicaim
    with bf16 and int8 KV and select_blocks 1 and 4 (13 decode-kernel
    launches a step, 13 flash_prefill launches a prompt pass), the kernel's
    prompt pass against the plain one (kept positions in each of the 13
    caches >= KEPT_MIN, bf16 and int8; the teacher-forced top-1 agreement
    printed), a decode step and a prompt pass profiled, a prefix-cache
    exact hit. Returns the launches of each kernel."""
    t_all = time.monotonic()
    launches = dict.fromkeys(launch_counts(), 0)

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    t0 = time.monotonic()
    cfg, params = family_weights("mamba2-1.3b", smi)
    dense = baselines.dense(PROMPT_LEN + NEW_TOKENS)
    streams = []
    for _ in range(2):
        _, _, _, model, handles, _ = phase_serve(cfg, params, "bf16", smi, 1,
                                                 prune=dense)
        streams.append([h.tokens for h in handles])
    print(f"[ssm] {cfg.name}: the second serve's greedy streams equal the "
          f"first's {streams[0] == streams[1]}")
    assert streams[0] == streams[1]
    ssm_continuity(cfg, params, model)
    batch = recurrent_batch(cfg)
    logits, st = model.prefill(params, batch)
    phase_profile(params, model, st, torch.argmax(logits, -1))
    part_prefill_profile(cfg, params, model, batch, transformer_mod,
                         "ssm_prefill", "SSD blocks", cfg.num_layers)
    add(recurrent_prefix_splice(cfg, params, model, smi))
    family_done(cfg.name, t0, smi)
    del params, model, st, logits, handles
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[ssm] after mamba2-1.3b: {held / 2 ** 30:.3f} GiB still "
          f"allocated on the card")
    assert held < 1 << 30, held

    t0 = time.monotonic()
    cfg, params = family_weights("zamba2-7b", smi)
    batch = recurrent_batch(cfg)
    served = {}
    for blocks, kv in itertools.product((1, 4), ("bf16", "int8")):
        t = time.monotonic()
        # cut to 4 requests of half the new tokens
        kernel, n, flash, model, _, _ = phase_serve(
            cfg, params, kv, smi, blocks, n=LANES, new=NEW_TOKENS // 2)
        assert model.attn_layer_count() == 13
        launches[kernel] += n
        launches["flash_prefill"] += flash
        if blocks == 1:
            served[kv] = model
        print(f"[ssm] {cfg.name} kv={kv} select_blocks={blocks}: "
              f"{time.monotonic() - t:.1f}s")
    t = time.monotonic()
    for kv, model in served.items():
        kept, _, step_ms = prompt_teacher(cfg, params, model, batch=batch)
        assert kept >= KEPT_MIN, (kv, kept, KEPT_MIN)
    print(f"[ssm] {cfg.name} kept positions {time.monotonic() - t:.1f}s")
    model = served["bf16"]
    logits, st = model.prefill(params, batch)
    phase_profile(params, model, st, torch.argmax(logits, -1))
    del st, logits
    part_prefill_profile(cfg, params, model, batch, transformer_mod,
                         "ssm_prefill", "SSD blocks", cfg.num_layers)
    add(recurrent_prefix_splice(cfg, params, model, smi))
    family_done(cfg.name, t0, smi)
    del params, served, model
    print(f"[ssm] phase 11 {time.monotonic() - t_all:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 12: the enc-dec family (whisper-base)
# ---------------------------------------------------------------------------

# the decoder's prompt lengths: the stress config's 2,048 (above heavy: the
# static top-k prunes) and whisper's own decoder context, 448 (below the
# budget: the cache keeps every position); four equal prompts each, as the
# reference's enc-dec prefill takes no length
ENCDEC_LENS = (PROMPT_LEN, 448)


def encdec_batch(cfg, n):
    """LANES prompts of `n` tokens and a seeded enc_embed [LANES, 1500, d]
    (whisper's 30 s window after the conv stub), on the card."""
    rng = np.random.default_rng(SEED + 12)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (LANES, n)),
                                      device="cuda"),
            "enc_embed": torch.randn((LANES, cfg.frontend_len, cfg.d_model),
                                     generator=gen, device="cuda")}


def encdec_serve(cfg, params, kv, blocks, n, smi):
    """The CLI's path for an enc-dec model: `Model.prefill` of
    `encdec_batch(cfg, n)`, then NEW_TOKENS greedy tokens through
    `decode_block`. Held: the prompt pass launches flash_prefill once a
    decoder layer and nothing else, and leaves every lane's cache step at
    n; the decode launches the decode kernel (ragged_decode, or
    fused_decode with `blocks` > 1) once a layer a step and nothing else;
    no plain prompt attention on the card; the tokens lie in the
    vocabulary. Printed: TTFT, wall, tok/s, the cross K/V's bytes.
    Returns (decode kernel, its launches, flash_prefill launches,
    model)."""
    prune = baselines.unicaim(kv_dtype=kv, select_blocks=blocks, fused=True,
                              **FAMILY_PRUNE)
    kernel = "fused_decode" if blocks > 1 else "ragged_decode"
    model = Model(cfg, prune, device="cuda")
    layers = model.attn_layer_count()
    batch = encdec_batch(cfg, n)
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    logits, st = model.prefill(params, batch)
    torch.cuda.synchronize()
    ttft = time.monotonic() - t0
    prompt = launch_counts()
    flash = prompt.pop("flash_prefill")
    steps = st.kv.step.clone()
    cross_bytes = sum(a.numel() * a.element_size() for a in st.cross)
    reset_launches()
    t1 = time.monotonic()
    st, _, toks = decode_block(model, params, st, torch.argmax(logits, -1),
                               NEW_TOKENS)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    counts = launch_counts()
    launches = counts.pop(kernel)
    print(f"  {cfg.name} kv={kv} select_blocks={blocks}: {LANES} prompts of "
          f"{n} tokens behind {cfg.frontend_len} encoder frames; a prefill "
          f"(TTFT) {ttft:.3f}s, then {NEW_TOKENS} steps through decode_block "
          f"{t2 - t1:.3f}s: {LANES * NEW_TOKENS} tokens in {t2 - t0:.3f}s = "
          f"{LANES * NEW_TOKENS / (t2 - t0):.1f} tok/s; cache step after the "
          f"prefill {sorted(set(steps.flatten().tolist()))}, fill "
          f"{sorted(set(st.kv.fill.flatten().tolist()))} after the decode; "
          f"cross K/V {cross_bytes} B ({st.cross[0].dtype}); flash_prefill "
          f"launches {flash} = {layers} x 1 (prompt pass: other kernels "
          f"{prompt}); {kernel} {launches} = {layers} x {NEW_TOKENS} (decode: "
          f"other kernels {counts}); plain prompt attention on the card "
          f"{PLAIN_ON_CARD}  [{smi}]")
    assert layers == cfg.dec_layers
    assert flash == layers and not any(prompt.values()), (flash, prompt)
    assert torch.equal(steps, torch.full_like(steps, n)), steps
    assert torch.isfinite(logits).all()
    assert launches == layers * NEW_TOKENS, launches
    assert not any(counts.values()), counts
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    assert toks.shape == (NEW_TOKENS, LANES)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert torch.equal(st.kv.step, torch.full_like(steps, n + NEW_TOKENS))
    return kernel, launches, flash, model


def phase_encdec(smi):
    """Phase 12: whisper-base at full width and depth (6 + 6 blocks, d 512,
    8 heads of d = 64, vocab 51,865), random bf16 weights from the seed:
    `encdec_serve` at both prompt lengths, bf16 and int8 KV, select_blocks
    1 and 4; at 2,048 tokens the kernel's prompt pass against the plain
    one (kept positions in each of the 6 caches >= KEPT_MIN, bf16 and int8:
    at 448 the cache keeps every row whatever the kernel computes); the
    decode kernel's path against the composed one, teacher-forced from the
    2,048-token state (top-1 >= TEACHER_AGREE_MIN of 64) and printed from
    the 448-token states; a 4 x 2048 prompt pass (the encoder's share) and
    a decode step profiled. Returns the launches of each kernel."""
    t_all = time.monotonic()
    cfg, params = family_weights("whisper-base", smi)
    launches = dict.fromkeys(launch_counts(), 0)
    served = {}
    for n, blocks, kv in itertools.product(ENCDEC_LENS, (1, 4),
                                           ("bf16", "int8")):
        t = time.monotonic()
        kernel, k_n, flash, model = encdec_serve(cfg, params, kv, blocks, n,
                                                 smi)
        launches[kernel] += k_n
        launches["flash_prefill"] += flash
        if blocks == 1:
            served[n, kv] = model
        print(f"[encdec] n={n} kv={kv} select_blocks={blocks}: "
              f"{time.monotonic() - t:.1f}s")
    t = time.monotonic()
    for (n, kv), model in served.items():
        if n > FAMILY_PRUNE["heavy"]:
            kept, _, _ = prompt_teacher(cfg, params, model,
                                        batch=encdec_batch(cfg, n))
            assert kept >= KEPT_MIN, (n, kv, kept, KEPT_MIN)
        else:
            phase_teacher(cfg, params, model, batch=encdec_batch(cfg, n),
                          hold=False)
    model = served[PROMPT_LEN, "bf16"]
    batch = encdec_batch(cfg, PROMPT_LEN)
    phase_teacher(cfg, params, model, batch=batch)
    print(f"[encdec] teacher-forced {time.monotonic() - t:.1f}s")
    part_prefill_profile(cfg, params, model, batch, model, "_encode",
                         "encoder", 1)
    logits, st = model.prefill(params, batch)
    phase_profile(params, model, st, torch.argmax(logits, -1))
    del st, logits
    family_done(cfg.name, t_all, smi)
    del params, served, model
    print(f"[encdec] phase 12 {time.monotonic() - t_all:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

# the backward kernel's shapes on the training path, at B x N = 4 x 2048:
# (model, q-heads, kv-heads, head dim)
BWD_SHAPES = (("granite-3-2b", 32, 8, 64), ("longchat-7b", 32, 32, 128),
              ("starcoder2-3b", 24, 2, 128), ("zamba2-7b", 32, 32, 112),
              ("whisper-base", 8, 8, 64))
# kernel vs plain, bf16: both round the same f32 sums, taken in other
# orders, to bf16 (dP, dq, dk, dv). Each element is held to one bf16 ulp
# of itself plus one of the largest gradient of its row (dq: its query
# row; dk, dv: its key row), as the gradients shrink about as
# 1/sqrt(row) along the sequence
BWD_TOL = 2.0 ** -7
BWD_F32_ATOL = 1e-5                # f32: the sum order alone
# granite-3-2b through the training CLI's settings (--batch 8 --seq 256
# --lr 1e-3; warmup 100 of the schedule), int8 moments (--quantized-opt:
# a checkpoint is about 10 GB where f32 moments make it 25 GB); a
# checkpoint every 4 steps and a RuntimeError injected before step 9,
# after the second one
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 10, 8, 256, 1e-3
CKPT_EVERY, FAIL_AT = 8, 9         # checkpoints of 10 GB at steps 8 and 10
# the resumed losses must equal the uninterrupted run's bit for bit: the
# restored state is the checkpoint's bits and every kernel of the step is
# deterministic
CKPT_DIR = ROOT / "build" / "train_ckpt"
WHISPER_TRAIN = (4, 448, 3)        # batch, decoder tokens, steps
REMAT_LAYERS = 4                   # granite-3-2b's depth for the remat check


def bwd_bound(b, hq, hk, n, d, dout_bytes=4, dv=None):
    """(bound_ms, bound_by, flop, bytes) of the attention backward at head
    dims (d, dv) (dv = d unless given): five products over the causal
    triangle at the bf16 peak, q.k, dS.k and dS^T.q over d, dout.v and
    P^T.dout over dv; q, k, dq, dk, dv in bf16, and dout in f32 (4 bytes)
    or bf16 (2), each moved once. MLA's latent (dv given and below d) is
    one tensor as K and V: it is read once and its gradient du, d wide,
    written once in place of dk and dv."""
    dv = d if dv is None else dv
    out_bytes = (2 * b * hk * n * d if dv < d      # the latent's du
                 else 2 * b * hk * n * (d + 2 * dv))   # dk, v read, dv
    flop = 2 * b * hq * (n * (n + 1) // 2) * (3 * d + 2 * dv)
    nbytes = (2 * (2 * b * hq * n * d + b * hk * n * d) + out_bytes
              + dout_bytes * b * hq * n * dv)
    t, by = bound(nbytes, bf16_flops=flop)
    return t, by, flop, nbytes


def bwd_kernel_name(text):
    """`bwd_dq_tc_kernel<64, bf16 dout>` for a mangled backward kernel name
    (the bf16 route's template arguments: head dim, dout split from f32;
    the latent route's: dout split from f32; the f32 route's: float, head
    dim), or None."""
    m = re.search(r"(bwd_dq_tc_kernel|bwd_dkv_tc_kernel)ILi(\d+)ELb([01])E",
                  text)
    if m:
        return (f"{m.group(1)}<{m.group(2)}, "
                f"{'f32' if m.group(3) == '1' else 'bf16'} dout>")
    m = re.search(r"(bwd_dq_latent_kernel|bwd_du_latent_kernel)ILb([01])E",
                  text)
    if m:
        return f"{m.group(1)}<{'f32' if m.group(2) == '1' else 'bf16'} dout>"
    for name in LATENT_PLAIN_KERNELS:
        if name in text:
            return name
    m = re.search(r"(bwd_dq_kernel|bwd_dkv_kernel)IfLi(\d+)E", text)
    return f"{m.group(1)}<float, {m.group(2)}>" if m else None


# the latent route's kernels without a warpgroup product: the f32 dout's
# split pass and the slices' sum
LATENT_PLAIN_KERNELS = ("split_dout_kernel", "sum_slices_kernel")


def bwd_kernel_report():
    """Registers, stack and local memory (spills) and HGMMA (warpgroup
    product) instructions of every backward kernel instantiation, read by
    cuobjdump from the built library and printed; fails unless every bf16
    (wgmma) instantiation, the latent route's too, holds HGMMA and spills
    nothing, and the latent route's split pass and slice sum spill
    nothing. Returns the served head dims' numbers and the latent
    route's."""
    tool = cuobjdump()
    if tool is None:
        print("[train] cuobjdump not found: the backward kernels' registers, "
              "spills and HGMMA count not measured")
        return {"compiled": "not measured"}
    lib = str(build.library_path("flash_prefill_bwd"))
    report = res_usage(tool, "flash_prefill_bwd", bwd_kernel_name)
    for r in report.values():
        r["hgmma"] = 0
    name = None
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for line in sass.splitlines():
        if "Function :" in line:
            name = bwd_kernel_name(line)
        elif name and "HGMMA" in line:
            report[name]["hgmma"] += 1
    lat = {n: r for n, r in report.items() if "latent" in n
           or n in LATENT_PLAIN_KERNELS}
    for n in sorted(lat):
        r = report.pop(n)
        print(f"[mla-train] {n}: {r['registers']} registers, "
              f"{r['stack_bytes']} B stack, {r['local_bytes']} B local "
              f"(spills), {r['hgmma']} HGMMA instructions in its SASS "
              "(cuobjdump)")
        assert r["stack_bytes"] == r["local_bytes"] == 0, (n, "spills")
        assert n in LATENT_PLAIN_KERNELS or r["hgmma"] > 0, (n, "no wgmma")
    assert len(lat) == 6, sorted(lat)
    tc = {n: r for n, r in report.items() if "_tc_" in n}
    served = sorted(n for n in tc if any(f"<{d}," in n
                                         for d in (64, 112, 128)))
    for n in served:
        r = report[n]
        print(f"[train] {n}: {r['registers']} registers, {r['stack_bytes']} "
              f"B stack, {r['local_bytes']} B local (spills), {r['hgmma']} "
              "HGMMA instructions in its SASS (cuobjdump)")
    f32 = {n: r for n, r in report.items() if n not in tc}
    for name, group in (("bf16 (wgmma)", tc), ("f32 (CUDA-core)", f32)):
        rs = group.values()
        print(f"[train] the {len(group)} {name} backward instantiations "
              "(head dims 16 to 128): registers "
              f"{sorted({r['registers'] for r in rs})}, HGMMA counts "
              f"{sorted({r['hgmma'] for r in rs})}, stack + local bytes "
              f"{sorted({r['stack_bytes'] + r['local_bytes'] for r in rs})}")
    want = {f"{k}<{d}, {dt} dout>" for k in ("bwd_dq_tc_kernel",
                                             "bwd_dkv_tc_kernel")
            for d in range(16, 129, 16) for dt in ("f32", "bf16")}
    assert want <= set(tc), sorted(want - set(tc))
    for n, r in tc.items():
        assert r["hgmma"] > 0, (n, "no wgmma")
        assert r["stack_bytes"] == r["local_bytes"] == 0, (n, "spills")
    return {"compiled": {n: tc[n] for n in served}, "latent_compiled": lat}


def bwd_check(model, hq, hk, d, seed, b=4, n=2048, dtype=torch.bfloat16,
              dout_dtype=torch.float32, yardsticks=False):
    """The kernel against its plain version on seeded q, k, v and dout (in
    `dout_dtype`): each element's error against its limit, two launches
    bit-equal; on bf16 inputs the kernel's CUDA-event time beside the
    bound and, with `yardsticks`, the plain version's and SDPA's backward
    (K/V expanded over the q-heads)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(
        dtype) for h in (hq, hk, hk))
    dout = torch.randn((b, hq, n, d), generator=gen,
                       device="cuda").to(dout_dtype)
    got = bwd_mod.flash_prefill_bwd(q, k, v, dout)
    again = bwd_mod.flash_prefill_bwd(q, k, v, dout)
    want = ref.flash_prefill_bwd_ref(q, k, v, dout)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    errs = {}
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        top = float(w.float().abs().max())
        diff = (x.float() - w.float()).abs()
        err = float(diff.max())
        if dtype == torch.bfloat16:
            a = w.float().abs()
            reading = float((diff / (BWD_TOL * (a + a.amax(-1, True))
                                     ).clamp_min(1e-30)).max())
        else:
            reading = err / BWD_F32_ATOL
        assert reading <= 1.0, (model, name, err, reading)
        errs[name] = (err, top, reading)
        del diff
    assert same, (model, "two launches differ")
    del got, again, want
    out = {"errors": errs, "bit_equal": same}
    tag = f"{str(dtype)[6:]}, dout {str(dout_dtype)[6:]}"
    line = ""
    if dtype == torch.bfloat16:
        t, by, flop, nbytes = bwd_bound(b, hq, hk, n, d,
                                        dout.element_size())
        ms = cuda_ms(lambda: bwd_mod.flash_prefill_bwd(q, k, v, dout))
        out.update(ms=ms, bound_ms=t, bound_by=by, flop=flop, bytes=nbytes)
        line = (f"; kernel {ms:.4f} ms, bound {t:.4f} ms ({by}: {flop:.4g} "
                f"flop, {nbytes} B), kernel / bound {ms / t:.1f}x")
    if dtype == torch.bfloat16 and yardsticks:
        plain = long_ms(lambda: ref.flash_prefill_bwd_ref(q, k, v, dout), 2)
        qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (
            q, k.repeat_interleave(hq // hk, dim=1),
            v.repeat_interleave(hq // hk, dim=1)))
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        do16 = dout.to(dtype)
        lib = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do16,
                                                  retain_graph=True), 5, 1)
        out.update(plain_ms=plain, library_ms=lib)
        line += (f"; plain {plain:.4f} ms; SDPA backward (K/V expanded) "
                 f"{lib:.4f} ms")
        del qg, kg, vg, o
    print(f"[train] flash_prefill_bwd {model} (B={b} Hq={hq} Hk={hk} N={n} "
          f"d={d} {tag}): max|err|/max|grad| "
          + ", ".join(f"{k} {e:.3g}/{m:.3g}" for k, (e, m, _) in
                      errs.items())
          + "; worst |err| / limit "
          + ", ".join(f"{k} {r:.3g}" for k, (_, _, r) in errs.items())
          + f" (limit {BWD_TOL:.4g} x (|grad| + max|grad| of its row) in "
          f"bf16, {BWD_F32_ATOL} in f32); two launches bit-equal: {same}"
          + line)
    return out


def plain_bwd_one_chunk(q, k, v, dout, scale, tc_dp):
    """`ref.flash_prefill_bwd_ref`'s arithmetic over one chunk (N <= its
    512 rows), with `tc_dp` its one product dP = dout v^T summed by a bf16
    GEMM on the tensor cores (cuBLAS) instead of in f32: a change of that
    sum's order alone, as any other implementation makes one."""
    b, hq, n, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    qg = q.to(k.dtype).float().reshape(b, hk, g * n, d)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(b, hk, g * n, v.shape[-1])
    row = torch.arange(n, device=q.device)
    logits = torch.matmul(qg, kf.transpose(-1, -2)).reshape(b, hk, g, n, n)
    logits = torch.where(row[:, None] >= row[None, :], logits * scale,
                         torch.full_like(logits, ref.NEG_INF))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    p_round = p.to(v.dtype).float().reshape(b, hk, g * n, n)
    dv = torch.matmul(p_round.transpose(-1, -2), do)
    if tc_dp:
        dp = torch.matmul(do.to(v.dtype), v.transpose(-1, -2)).float()
    else:
        dp = torch.matmul(do, vf.transpose(-1, -2)).to(v.dtype).float()
    dp = dp.reshape(b, hk, g, n, n)
    dd = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - dd) * scale).reshape(b, hk, g * n, n)
    dq = torch.matmul(ds, kf).to(k.dtype).reshape(b, hq, n, d)
    dk = torch.matmul(ds.transpose(-1, -2), qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_reading(x, w):
    """(worst |err| / limit over every row, over the rows with a gradient:
    a row whose largest |w| is above 1e-3 of the tensor's), the limit
    BWD_TOL x (|w| + max|w| of its row)."""
    a = w.float().abs()
    top = a.amax(-1, True)
    r = (x.float() - w.float()).abs() / (BWD_TOL * (a + top)).clamp_min(
        1e-30)
    return float(r.max()), float((r * (top > 1e-3 * a.max())).max())


def train_batch_fn(cfg, b, t, seed=SEED):
    src = SyntheticSource(cfg.vocab_size, t, seed=seed)

    def data_iter(step):
        batch = {"tokens": src.batch(step, b),
                 **train_mod.frontend_inputs(cfg, step, b, seed)}
        return {k: torch.as_tensor(v, device="cuda") for k, v in
                batch.items()}
    return data_iter


def train_run(model, opt_cfg, data_iter, steps, fail_at=None, ckpt=None):
    """`steps` steps of the training CLI's step function from the seed's
    state: straight (no checkpoint), or through `fault.run_training` with
    a checkpoint every CKPT_EVERY and a RuntimeError injected once before
    `fail_at`. Returns ({step: [losses]}, stats, launches, wall s)."""
    state = train_mod.init_train_state(model, opt_cfg, SEED)
    step_fn = train_mod.make_train_step(model, opt_cfg, steps,
                                        peak_lr=TRAIN_LR)
    losses = {}

    def on_metrics(i, m):
        losses.setdefault(i, []).append(float(m["loss"]))

    torch.cuda.synchronize()
    reset_launches()
    PLAIN_ON_CARD.update(dict.fromkeys(PLAIN_ON_CARD, 0))
    t0 = time.monotonic()
    if ckpt is None:
        stats = None
        for i in range(steps):
            state, m = step_fn(state, data_iter(i))
            on_metrics(i, m)
    else:
        failed = []

        def inject(i):
            if i == fail_at and not failed:
                failed.append(i)
                raise RuntimeError(f"injected failure before step {i}")
        state, stats = fault.run_training(
            step_fn, state, data_iter, steps, ckpt,
            fault.FaultConfig(ckpt_every=CKPT_EVERY, max_restarts=1),
            inject_failure=inject, on_metrics=on_metrics)
        assert int(state.opt.step) == steps, int(state.opt.step)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    del state
    return losses, stats, counts, wall


def remat_check(cfg, prune):
    """The gradients of one loss (granite-3-2b at full width, cut to
    REMAT_LAYERS layers, one TRAIN_BATCH x TRAIN_SEQ batch) under remat
    'nothing' and 'dots' against those without remat, bit for bit, with
    each run's launches: the selective checkpoint of 'dots' wraps a ctypes
    launch the dispatcher never sees, so its recomputation must still run
    the kernel."""
    cfg = dataclasses.replace(cfg, num_layers=REMAT_LAYERS)
    params = Model(cfg, prune, device="cuda").init(SEED)
    batch = train_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ)(0)
    grads, counts = {}, {}
    for remat, policy in ((False, "nothing"), (True, "nothing"),
                          (True, "dots")):
        model = Model(cfg, prune, device="cuda", remat=remat,
                      remat_policy=policy)
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        torch.cuda.synchronize()
        reset_launches()
        loss, _ = train_mod.make_loss_fn(model)(live, batch)
        g = torch.autograd.grad(loss, leaves(live), allow_unused=True)
        torch.cuda.synchronize()
        key = policy if remat else "none"
        grads[key], counts[key] = g, launch_counts()
        del live, loss
    want_fwd = {"none": 1, "nothing": 2, "dots": 2}
    for key, c in counts.items():
        assert c["flash_prefill"] == want_fwd[key] * REMAT_LAYERS, (key, c)
        assert c["flash_prefill_bwd"] == REMAT_LAYERS, (key, c)
    same = {}
    for key in ("nothing", "dots"):
        same[key] = all((a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(grads["none"], grads[key]))
        assert same[key], key
    print(f"[train] remat: granite-3-2b cut to {REMAT_LAYERS} layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: gradients under 'nothing' "
          f"and 'dots' bit-equal to those without remat: "
          f"{same['nothing']} / {same['dots']}; flash_prefill launches "
          + " / ".join(f"{k} {c['flash_prefill']}" for k, c in counts.items())
          + ", flash_prefill_bwd "
          + " / ".join(f"{k} {c['flash_prefill_bwd']}"
                       for k, c in counts.items()))
    del grads, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts.values())
            for k in ("flash_prefill", "flash_prefill_bwd")}


def train_step_profile(model, opt_cfg, batch):
    """One training step at `batch` from the seed's state: wall, tokens/s,
    peak memory, its launches; then one under torch.profiler: the backward
    kernels' share of the step's kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = train_mod.init_train_state(model, opt_cfg, SEED)
    step_fn = train_mod.make_train_step(model, opt_cfg, 10, peak_lr=TRAIN_LR)
    state, _ = step_fn(state, batch)                       # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    state, m = step_fn(state, batch)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    bwd = sum(dev_us(e) for e in kernels if "bwd_dq" in e.key
              or "bwd_dkv" in e.key or "bwd_du" in e.key
              or any(k in e.key for k in LATENT_PLAIN_KERNELS)) / 1e3
    fwd = sum(dev_us(e) for e in kernels if "flash_prefill_" in e.key
              and "bwd" not in e.key or "fold_columns" in e.key) / 1e3
    del state
    top = sorted(((e.key, dev_us(e) / 1e3) for e in kernels),
                 key=lambda x: -x[1])[:5]
    return {"wall_s": wall, "loss": float(m["loss"]), "peak": peak,
            "launches": counts, "busy_ms": busy, "bwd_ms": bwd,
            "fwd_ms": fwd, "n_kernels": sum(e.count for e in kernels),
            "top": top}


def phase_train(smi):
    """Phase 13: the attention backward kernel against its plain version at
    the training path's five shapes, then granite-3-2b (full width and
    depth) through the training CLI's functions, uninterrupted and with a
    failure and a resume, the kernel on its own inputs, a profiled step at
    4 x 2048 under remat, and whisper-base (full) for a few steps. Returns
    (the backward kernel's row, the launches of the main-path runs, the
    latent route's registers, spills and HGMMA for phase 14's row)."""
    t_all = time.monotonic()
    compiled = bwd_kernel_report()
    latent_compiled = compiled.pop("latent_compiled")
    checks = {}
    for i, (name, hq, hk, d) in enumerate(BWD_SHAPES):
        # the model's cotangent is bf16 (its out is cast to bf16); an f32
        # one takes the hi + lo split
        checks[name] = bwd_check(name, hq, hk, d, seed=SEED + 130 + i,
                                 dout_dtype=torch.bfloat16, yardsticks=True)
        checks[name]["f32_dout"] = bwd_check(name, hq, hk, d,
                                             seed=SEED + 130 + i)
        gc.collect()
        torch.cuda.empty_cache()
    checks["f32"] = bwd_check("reduced (f32)", 4, 2, 16, SEED + 139, b=2,
                              n=300, dtype=torch.float32)
    print(f"[train] kernel checks {time.monotonic() - t_all:.1f}s")
    launches = dict.fromkeys(launch_counts(), 0)

    # granite-3-2b: the uninterrupted run, then the faulted one
    t = time.monotonic()
    cfg = get_config("granite-3-2b")
    model = Model(cfg, baselines.unicaim(heavy=min(448, TRAIN_SEQ),
                                         reserve=64, select_k=64),
                  device="cuda")
    opt_q = adamw.AdamWConfig(lr=TRAIN_LR, quantized_state=True)
    data = train_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    clean, _, c_clean, w_clean = train_run(model, opt_q, data, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    assert c_clean["flash_prefill"] == layers * TRAIN_STEPS, c_clean
    assert c_clean["flash_prefill_bwd"] == layers * TRAIN_STEPS, c_clean
    print(f"[train] granite-3-2b (40 layers, d 2048, 32/8 heads of 64, "
          f"2.53e9 params, bf16, int8 moments) {TRAIN_STEPS} steps at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, lr {TRAIN_LR}: "
          f"{w_clean:.2f}s ({w_clean / TRAIN_STEPS * 1e3:.1f} ms a step, "
          f"{TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / w_clean:.0f} tokens/s); "
          f"losses {[round(clean[i][0], 4) for i in range(TRAIN_STEPS)]}; "
          f"flash_prefill {c_clean['flash_prefill']} and flash_prefill_bwd "
          f"{c_clean['flash_prefill_bwd']} launches (40 x {TRAIN_STEPS}); "
          f"peak {peak / 2 ** 30:.2f} GiB  [{smi}]")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ckpt = CheckpointManager(str(CKPT_DIR), keep=1)
    faulted, stats, c_f, w_f = train_run(model, opt_q, data, TRAIN_STEPS,
                                         fail_at=FAIL_AT, ckpt=ckpt)
    last = ckpt.latest_step()
    ckpt_bytes = sum(f.stat().st_size for f in CKPT_DIR.rglob("*")
                     if f.is_file())
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    passes = stats.steps                  # forward + backward passes run
    assert stats.restarts == 1 and last == TRAIN_STEPS, (stats, last)
    resumed = FAIL_AT // CKPT_EVERY * CKPT_EVERY   # the replay starts there
    assert passes == TRAIN_STEPS + (FAIL_AT - resumed), stats
    assert c_f["flash_prefill"] == layers * passes, c_f
    assert c_f["flash_prefill_bwd"] == layers * passes, c_f
    assert [len(faulted[i]) for i in range(TRAIN_STEPS)] == [
        1 + (resumed <= i < FAIL_AT) for i in range(TRAIN_STEPS)]
    bit_equal = all(faulted[i][-1] == clean[i][0] for i in range(TRAIN_STEPS))
    assert bit_equal, (clean, faulted)
    print(f"[train] granite-3-2b through fault.run_training (a checkpoint "
          f"every {CKPT_EVERY} steps, keep 1, {ckpt_bytes} B each on disk; "
          f"a RuntimeError before step {FAIL_AT}): {w_f:.2f}s, restarts "
          f"{stats.restarts}, final opt.step {TRAIN_STEPS}, {passes} passes; "
          f"resumed losses bit-equal to the uninterrupted ones: "
          f"{bit_equal}; launches "
          f"{c_f['flash_prefill']} / {c_f['flash_prefill_bwd']} (40 x "
          f"{passes})  [{smi}]")
    for k in ("flash_prefill", "flash_prefill_bwd"):
        launches[k] += c_clean[k] + c_f[k]
    print(f"[train] granite-3-2b runs {time.monotonic() - t:.1f}s")

    # remat 'nothing' and 'dots' at a cut depth
    t = time.monotonic()
    for k, n in remat_check(cfg, model.prune).items():
        launches[k] += n
    print(f"[train] remat check {time.monotonic() - t:.1f}s")

    # one step at 4 x 2048 tokens, f32 moments, remat
    t = time.monotonic()
    model = Model(cfg, model.prune, device="cuda", remat=True)
    big = {"tokens": torch.as_tensor(SyntheticSource(
        cfg.vocab_size, PROMPT_LEN, seed=SEED).batch(0, LANES),
        device="cuda")}
    prof = train_step_profile(model, adamw.AdamWConfig(lr=TRAIN_LR), big)
    assert prof["launches"]["flash_prefill"] == 2 * layers, prof
    assert prof["launches"]["flash_prefill_bwd"] == layers, prof
    share = ("not measured" if prof["busy_ms"] == 0 else
             f"{prof['bwd_ms'] / prof['busy_ms']:.1%}")
    print(f"[train] granite-3-2b one step at {LANES} x {PROMPT_LEN} tokens "
          f"(f32 moments, remat 'nothing'): {prof['wall_s'] * 1e3:.1f} ms "
          f"wall, {LANES * PROMPT_LEN / prof['wall_s']:.0f} tokens/s, loss "
          f"{prof['loss']:.4f}, peak {prof['peak'] / 2 ** 30:.2f} GiB; "
          f"launches flash_prefill {prof['launches']['flash_prefill']} (40 x "
          f"2: remat), flash_prefill_bwd "
          f"{prof['launches']['flash_prefill_bwd']}; profiled: "
          f"{prof['busy_ms']:.1f} ms of kernel time in "
          f"{prof['n_kernels']} kernels, flash_prefill_bwd "
          f"{prof['bwd_ms']:.1f} ms ({share}), flash_prefill "
          f"{prof['fwd_ms']:.1f} ms  [{smi}]")
    for k in ("flash_prefill", "flash_prefill_bwd"):
        launches[k] += prof["launches"][k]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] 4 x 2048 step {time.monotonic() - t:.1f}s")

    # whisper-base, full width and depth
    t = time.monotonic()
    wcfg = get_config("whisper-base")
    wb, wt, ws = WHISPER_TRAIN
    wmodel = Model(wcfg, baselines.unicaim(**FAMILY_PRUNE), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    wl, _, c_w, w_w = train_run(wmodel, adamw.AdamWConfig(lr=TRAIN_LR),
                                train_batch_fn(wcfg, wb, wt), ws)
    assert c_w["flash_prefill"] == wcfg.dec_layers * ws, c_w
    assert c_w["flash_prefill_bwd"] == wcfg.dec_layers * ws, c_w
    assert all(math.isfinite(wl[i][0]) for i in range(ws)), wl
    print(f"[train] whisper-base (6 + 6 blocks, d 512, 8 heads of 64, "
          f"[{wb}, {wcfg.frontend_len}, {wcfg.d_model}] enc_embed, {wt} "
          f"decoder tokens) {ws} steps, f32 moments: {w_w:.2f}s, losses "
          f"{[round(wl[i][0], 4) for i in range(ws)]}, launches "
          f"{c_w['flash_prefill']} / {c_w['flash_prefill_bwd']} (6 x {ws}), "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB  "
          f"[{smi}]")
    for k in ("flash_prefill", "flash_prefill_bwd"):
        launches[k] += c_w[k]
    del wmodel
    print(f"[train] phase 13 {time.monotonic() - t_all:.1f}s")

    g = checks["granite-3-2b"]
    worst_err = max(e for c in checks.values()
                    for x in (c, c.get("f32_dout", c))
                    for e, _, _ in x["errors"].values())
    row = {
        "name": "flash_prefill_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill_bwd.cu",
        "replaces": ("none: the reference differentiates plain XLA "
                     "(src/repro/core/attention.py:490 under "
                     "jax.value_and_grad at src/repro/launch/train.py:95)"),
        "launches": launches["flash_prefill_bwd"],
        "max_abs_err": worst_err, "ms": g["ms"], "plain_ms": g["plain_ms"],
        "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
        "library_ms": g["library_ms"],
        "ms_f32_dout": g["f32_dout"]["ms"],
        "shapes": {k: {**{f: c[f] for f in ("ms", "plain_ms", "bound_ms",
                                             "library_ms") if f in c},
                       **({"ms_f32_dout": c["f32_dout"]["ms"]}
                          if "f32_dout" in c else {})}
                   for k, c in checks.items()},
        **compiled,
        "granite_step_4x2048": {"wall_ms": prof["wall_s"] * 1e3,
                                "kernel_ms": prof["busy_ms"],
                                "bwd_ms": prof["bwd_ms"],
                                "peak_gib": prof["peak"] / 2 ** 30}}
    return row, launches, latent_compiled

# ---------------------------------------------------------------------------
# phase 14: MLA training
# ---------------------------------------------------------------------------

# deepseek-v3-671b cut to its three mla_dense blocks (dense_first_k) and the
# MTP head, 4.29e9 parameters: one mla_moe block's 256 experts alone hold
# 11.3e9, about 68 GB with their bf16 gradients and int8 moments, which no
# single card holds beside the rest
MLA_TRAIN_LAYERS = 3
MLA_TRAIN_STEPS = 5
MLA_PROFILE_BATCH = 2              # x PROMPT_LEN tokens, remat 'nothing'
LATENT_DV = flash_mod.LATENT[1]


def latent_bwd_inputs(b, n, seed, dout_dtype):
    """q [B, 128, N, 576] and the latent u [B, 1, N, 576] bf16, v the view of
    its first 512 columns, and dout [B, 128, N, 512] in `dout_dtype`."""
    q, u, v = latent_inputs(b, n, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dout = torch.randn((b, LATENT_HEADS, n, LATENT_DV), generator=gen,
                       device="cuda").to(dout_dtype)
    return q, u, v, dout


def limit_reading(x, w, extra=None):
    """(worst |err| / limit, elements over it) with the limit BWD_TOL x
    (|w| + max|w| of its row), plus `extra` where given."""
    a = w.float().abs()
    lim = BWD_TOL * (a + a.amax(-1, True))
    if extra is not None:
        lim = lim + extra
    diff = (x.float() - w.float()).abs()
    return (float((diff / lim.clamp_min(1e-30)).max()),
            int((diff > lim).sum()))


def plain_latent(q, u, v, dout):
    """The plain version's dq and the latent's gradient du = dk + [dv, 0],
    summed in f32 and rounded once (`ref.latent_du`)."""
    dq, dk, dv = ref.flash_prefill_bwd_ref(q, u, v, dout, scale=LATENT_SCALE)
    return dq, ref.latent_du(dk, dv)


def latent_bwd_check(b, seed, dout_dtype, timed):
    """The latent route (q [B, 128, 2048, 576] over one latent, scale
    1/sqrt(192)) against its plain version: du (the latent's gradient
    through K and V) to BWD_TOL x (|ref| + max|ref| of the row) against the
    plain dk + [dv, 0], dq to that plus the move one dP element of its row
    rounding to its other bf16 neighbour makes
    (`ref.flash_prefill_bwd_dq_flip`: where dP - D cancels over a row, as
    on a few early rows of 512 q-heads, another summation order's flip
    moves dq by up to the row's whole size), the elements over the bare
    limit printed; two launches bit-equal. With `timed`, the kernel's
    CUDA-event time beside the bound and the plain version's."""
    n = PROMPT_LEN
    q, u, v, dout = latent_bwd_inputs(b, n, seed, dout_dtype)
    got = bwd_mod.flash_prefill_bwd(q, u, v, dout, LATENT_SCALE)
    again = bwd_mod.flash_prefill_bwd(q, u, v, dout, LATENT_SCALE)
    assert got[2] is None and again[2] is None, "the latent route gives du"
    want = plain_latent(q, u, v, dout)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got[:2], again[:2]))
    del again
    flip = ref.flash_prefill_bwd_dq_flip(q, u, v, dout, scale=LATENT_SCALE)
    errs = {}
    for name, x, w in zip(("dq", "du"), got, want):
        assert x.shape == w.shape and bool(torch.isfinite(x).all()), name
        bare, over = limit_reading(x, w)
        held = limit_reading(x, w, flip)[0] if name == "dq" else bare
        errs[name] = {"max_abs_err": float((x.float() - w.float()).abs()
                                           .max()),
                      "max_ref": float(w.float().abs().max()),
                      "reading": held, "bare_reading": bare,
                      "over_bare": over}
    del got, want, flip
    tag = f"B={b} dout {str(dout_dtype)[6:]}"
    out = {"errors": errs, "bit_equal": same}
    line = ""
    if timed:
        t, by, flop, nbytes = bwd_bound(b, LATENT_HEADS, 1, n,
                                        flash_mod.LATENT[0],
                                        dout.element_size(), dv=LATENT_DV)
        ms = cuda_ms(lambda: bwd_mod.flash_prefill_bwd(q, u, v, dout,
                                                       LATENT_SCALE), 5, 1)
        plain = long_ms(lambda: plain_latent(q, u, v, dout), 2)
        out.update(ms=ms, plain_ms=plain, bound_ms=t, bound_by=by, flop=flop,
                   bytes=nbytes)
        line = (f"; kernel {ms:.4f} ms, bound {t:.4f} ms ({by}: {flop:.4g} "
                f"flop, {nbytes} B), kernel / bound {ms / t:.1f}x, plain "
                f"{plain:.4f} ms")
    print(f"[mla-train] flash_prefill_bwd latent route ({tag}, Hq "
          f"{LATENT_HEADS}, N {n}): max|err|/max|grad| "
          + ", ".join(f"{k} {e['max_abs_err']:.3g}/{e['max_ref']:.3g}"
                      for k, e in errs.items())
          + "; worst |err| / limit " + ", ".join(
              f"{k} {e['reading']:.3g}" for k, e in errs.items())
          + f" (dq: limit plus one dP rounding flip of its row); against "
          f"the bare limit {BWD_TOL:.4g} x (|grad| + max|grad| of its row): "
          + ", ".join(f"{k} {e['bare_reading']:.3g} ({e['over_bare']} "
                      "elements over)" for k, e in errs.items())
          + f"; two launches bit-equal: {same}" + line)
    for name, e in errs.items():
        assert e["reading"] <= 1.0, (tag, name, e)
    assert same, (tag, "two launches differ")
    del q, u, v, dout
    gc.collect()
    torch.cuda.empty_cache()
    return out


def latent_split_check():
    """The latent route's f32 dout split pass (`bwd_mod.split_dout`)
    against its plain version (`ref.split_bf16_ref`), bit for bit, on a
    [4, 128, 256, 512] dout of `ref.split_bf16_cases` (60 binades, zeros
    of both signs, subnormals, the f32 extremes). Returns whether they
    agree."""
    x = ref.split_bf16_cases(
        (LANES, LATENT_HEADS, 256, LATENT_DV),
        torch.Generator(device="cuda").manual_seed(SEED + 149))
    same = torch.equal(bwd_mod.split_dout(x).view(torch.int16),
                       ref.split_bf16_ref(x).view(torch.int16))
    print(f"[mla-train] the latent route's dout split pass against "
          f"split_bf16's plain version on {x.numel()} f32 values: bit-equal "
          f"{same}")
    del x
    torch.cuda.empty_cache()
    assert same, "the dout split differs from its plain version"
    return same


def kernel_parts_ms(fn, calls=3):
    """`calls` calls of `fn` under torch.profiler, behind a 1e8-cycle
    `torch.cuda._sleep` lead so that the profile is running before the
    first of them reaches the card: the card time of each kernel they
    launch, by its name, in ms a launch over the launches the profile
    saw; "not measured" where it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(1e8))
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, seen = {}, {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)\b", e.key)
        if (e.device_type != DeviceType.CUDA or not m
                or m.group(1) == "spin_kernel"):      # the lead
            continue
        us[m.group(1)] = us.get(m.group(1), 0.0) + getattr(
            e, "self_device_time_total",
            getattr(e, "self_cuda_time_total", 0.0))
        seen[m.group(1)] = seen.get(m.group(1), 0) + e.count
    return ({k: us[k] / seen[k] / 1e3 for k in us if seen[k]}
            or "not measured: the profile saw no kernel")


def latent_bwd_times(b=LANES):
    """The latent route at B x 2048 rows, 128 q-heads, with the model's f32
    dout and a bf16 one: its CUDA-event time and its card time by kernel
    (`kernel_parts_ms`). A command of its own, in a fresh process (inside
    this script's long run the profile sees none of the route's kernels,
    `PERF.md` §7), which also times another checkout's route from that
    checkout's root:
    `PYTHONPATH=src python3 -c 'import chip_smoke as c; c.latent_bwd_times()'`.
    Prints one line and returns {dout: times}."""
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        q, u, v, dout = latent_bwd_inputs(b, PROMPT_LEN, SEED + 140 + b, dt)

        def call():
            bwd_mod.flash_prefill_bwd(q, u, v, dout, LATENT_SCALE)

        out[str(dt)[6:]] = {"ms": cuda_ms(call, 5, 1),
                            "parts_ms": kernel_parts_ms(call)}
        del q, u, v, dout
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[mla-train] latent route times at B={b}, N {PROMPT_LEN}, "
          f"{LATENT_HEADS} q-heads, from {ROOT}: {json.dumps(out)}  "
          f"[{smi_line()}]")
    return out


def latent_sdpa_bwd_ms():
    """The backward alone of the F.scaled_dot_product_attention(is_causal)
    call that times the latent forward (K and V expanded over the 128
    heads, bf16 dout), at B = 4; at B = 2 where no backend takes B = 4.
    Returns (ms, B)."""
    n = PROMPT_LEN
    for b in (LANES, 2):
        q, u, v = latent_inputs(b, n, SEED + 150)
        try:
            qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (
                q, u.expand(b, LATENT_HEADS, n, u.shape[-1]),
                v.expand(b, LATENT_HEADS, n, LATENT_DV)))
            o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                               scale=LATENT_SCALE)
            do = torch.randn_like(o)
            ms = cuda_ms(lambda: torch.autograd.grad(
                o, (qg, kg, vg), do, retain_graph=True), 3, 1)
            return ms, b
        except torch.OutOfMemoryError:
            print(f"[mla-train] SDPA backward at B={b}: out of memory")
        finally:
            del q, u, v
            gc.collect()
            torch.cuda.empty_cache()
    return None, None


def phase_mla_train(smi, compiled):
    """Phase 14: the latent route of the attention backward against its
    plain version (dq, and the latent's gradient du) and timed (CUDA
    events), its dout split pass bit for bit against its plain version,
    then deepseek-v3-671b at full width cut to its three mla_dense blocks and the MTP head (MLA_TRAIN_LAYERS) through the
    training CLI's functions: MLA_TRAIN_STEPS steps at TRAIN_BATCH x
    TRAIN_SEQ, int8 moments (4 flash_prefill and 4 flash_prefill_bwd
    launches a step, finite loss and mtp_loss), the kernel on layer 0's
    own inputs of the last step (printed), and one step at
    MLA_PROFILE_BATCH x PROMPT_LEN under remat, profiled. Returns (the
    latent route's kernel row, the launches of the main-path runs)."""
    t_all = time.monotonic()
    checks = {}
    for b in (2, LANES):
        for dt in (torch.float32, torch.bfloat16):
            checks[(b, dt)] = latent_bwd_check(b, SEED + 140 + b, dt,
                                               timed=b == LANES)
    split_same = latent_split_check()
    sdpa_ms, sdpa_b = latent_sdpa_bwd_ms()
    print(f"[mla-train] F.scaled_dot_product_attention(is_causal=True, K/V "
          f"expanded over {LATENT_HEADS} heads, dv {LATENT_DV}) backward "
          f"alone at B={sdpa_b}, N={PROMPT_LEN}: {sdpa_ms} ms  [{smi}]")
    print(f"[mla-train] kernel checks {time.monotonic() - t_all:.1f}s")

    t = time.monotonic()
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              num_layers=MLA_TRAIN_LAYERS)
    model = Model(cfg, baselines.unicaim(heavy=min(448, TRAIN_SEQ),
                                         reserve=64, select_k=64),
                  device="cuda")
    opt_q = adamw.AdamWConfig(lr=TRAIN_LR, quantized_state=True)
    torch.cuda.reset_peak_memory_stats()
    state = train_mod.init_train_state(model, opt_q, SEED)
    n_params = sum(x.numel() for x in _leaves(state.params))
    step_fn = train_mod.make_train_step(model, opt_q, MLA_TRAIN_STEPS,
                                        peak_lr=TRAIN_LR)
    data = train_batch_fn(cfg, TRAIN_BATCH, TRAIN_SEQ)
    kernel = ops._flash_bwd_kernel
    own = {}

    def capture(q, k, v, dout, scale=None):
        out = kernel(q, k, v, dout, scale=scale)
        # the step's last backward call is layer 0's
        own.update(args=tuple(x.clone() for x in (q, k, v, dout)),
                   out=out, scale=scale)
        return out

    metrics = []
    torch.cuda.synchronize()
    reset_launches()
    PLAIN_ON_CARD.update(dict.fromkeys(PLAIN_ON_CARD, 0))
    t0 = time.monotonic()
    for i in range(MLA_TRAIN_STEPS):
        if i == MLA_TRAIN_STEPS - 1:
            ops._flash_bwd_kernel = capture
        try:
            state, m = step_fn(state, data(i))
        finally:
            ops._flash_bwd_kernel = kernel
        metrics.append({k: float(x) for k, x in m.items()})
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    blocks = MLA_TRAIN_LAYERS + 1                 # + the MTP head's block
    assert counts["flash_prefill"] == blocks * MLA_TRAIN_STEPS, counts
    assert counts["flash_prefill_bwd"] == blocks * MLA_TRAIN_STEPS, counts
    assert all(math.isfinite(x[k]) for x in metrics
               for k in ("loss", "mtp_loss")), metrics
    print(f"[mla-train] deepseek-v3-671b ({MLA_TRAIN_LAYERS} mla_dense "
          f"blocks of 61 and the MTP head, d {cfg.d_model}, {cfg.n_heads} "
          f"heads over a latent of {cfg.mla.latent_dim}, {n_params} random "
          f"bf16 params, int8 moments) {MLA_TRAIN_STEPS} steps at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, lr {TRAIN_LR}: {wall:.2f}s "
          f"({wall / MLA_TRAIN_STEPS * 1e3:.1f} ms a step, "
          f"{MLA_TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall:.0f} "
          f"tokens/s); loss {[round(x['loss'], 4) for x in metrics]}, "
          f"mtp_loss {[round(x['mtp_loss'], 4) for x in metrics]}; "
          f"flash_prefill {counts['flash_prefill']} and flash_prefill_bwd "
          f"{counts['flash_prefill_bwd']} launches ({blocks} x "
          f"{MLA_TRAIN_STEPS}); peak {peak / 2 ** 30:.2f} GiB  [{smi}]")
    launches = {k: counts[k] for k in ("flash_prefill", "flash_prefill_bwd")}
    del state

    # layer 0's own inputs of the last step: printed, not held (ROADMAP.md
    # Queue C item 8)
    held = dict(PLAIN_ON_CARD)
    q, k, v, dout = own["args"]
    sc = own["scale"]
    dq, dk, dv = ref.flash_prefill_bwd_ref(q, k, v, dout, scale=sc)
    want = (dq, ref.latent_du(dk, dv))
    dq, dk, dv = plain_bwd_one_chunk(q, k, v, dout, sc, tc_dp=True)
    tc = (dq, ref.latent_du(dk, dv))
    del dq, dk, dv
    own_r = {"kernel": [bwd_reading(x, w)
                        for x, w in zip(own["out"][:2], want)],
             "plain, dP on the tensor cores": [
                 bwd_reading(x, w) for x, w in zip(tc, want)]}
    PLAIN_ON_CARD.update(held)
    print(f"[mla-train] the latent route on layer 0's own inputs (step "
          f"{MLA_TRAIN_STEPS - 1}, {TRAIN_BATCH} x {TRAIN_SEQ} rows, dout "
          f"{str(dout.dtype)[6:]}), worst |err| / limit for dq and du, all "
          "rows (rows with a gradient): " + "; ".join(
              f"{name} " + ", ".join(f"{a:.3g} ({b:.3g})" for a, b in r)
              for name, r in own_r.items())
          + " (printed, not held)")
    del own, q, k, v, dout, want, tc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mla-train] deepseek-v3 runs {time.monotonic() - t:.1f}s")

    # one step at 2 x 2048 tokens, remat, profiled
    t = time.monotonic()
    model = Model(cfg, model.prune, device="cuda", remat=True)
    big = {"tokens": torch.as_tensor(SyntheticSource(
        cfg.vocab_size, PROMPT_LEN, seed=SEED).batch(0, MLA_PROFILE_BATCH),
        device="cuda")}
    prof = train_step_profile(model, opt_q, big)
    assert prof["launches"]["flash_prefill"] == 2 * MLA_TRAIN_LAYERS + 1, \
        prof
    assert prof["launches"]["flash_prefill_bwd"] == blocks, prof
    for k in ("flash_prefill", "flash_prefill_bwd"):
        launches[k] += prof["launches"][k]
    tokens = MLA_PROFILE_BATCH * PROMPT_LEN
    busy = prof["busy_ms"]
    share = (lambda x: "not measured" if busy == 0 else f"{x / busy:.1%}")
    print(f"[mla-train] deepseek-v3 one step at {MLA_PROFILE_BATCH} x "
          f"{PROMPT_LEN} tokens (int8 moments, remat 'nothing'): "
          f"{prof['wall_s'] * 1e3:.1f} ms wall, {tokens / prof['wall_s']:.0f} "
          f"tokens/s, loss {prof['loss']:.4f}, peak "
          f"{prof['peak'] / 2 ** 30:.2f} GiB; launches flash_prefill "
          f"{prof['launches']['flash_prefill']} ({MLA_TRAIN_LAYERS} x 2: "
          f"remat, + the MTP block), flash_prefill_bwd "
          f"{prof['launches']['flash_prefill_bwd']}; profiled: {busy:.1f} ms "
          f"of kernel time in {prof['n_kernels']} kernels, the latent "
          f"backward {prof['bwd_ms']:.1f} ms ({share(prof['bwd_ms'])}), the "
          f"latent forward {prof['fwd_ms']:.1f} ms ({share(prof['fwd_ms'])})"
          "; the five kernels with the most time: " + "; ".join(
              f"{name[:80]} {ms:.1f} ms" for name, ms in prof["top"])
          + f"  [{smi}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mla-train] 2 x 2048 step {time.monotonic() - t:.1f}s")
    print(f"[mla-train] phase 14 {time.monotonic() - t_all:.1f}s")

    f32, b16 = checks[(LANES, torch.float32)], checks[(LANES, torch.bfloat16)]
    row = {
        "name": "flash_prefill_bwd_latent", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill_bwd.cu",
        "replaces": ("none: the reference differentiates plain XLA "
                     "(src/repro/models/mla.py:114 mla_train, "
                     "src/repro/core/attention.py:490 under "
                     "jax.value_and_grad at src/repro/launch/train.py:95)"),
        "launches": launches["flash_prefill_bwd"],
        "max_abs_err": max(e["max_abs_err"] for c in checks.values()
                           for e in c["errors"].values()),
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": sdpa_ms, "library_batch": sdpa_b,
        "bf16_dout": {k: b16[k] for k in ("ms", "plain_ms", "bound_ms")},
        "split_bit_equal": split_same,
        "readings": {f"B{b} {str(dt)[6:]}": {
            **{k: e["reading"] for k, e in c["errors"].items()},
            "over_bare": {k: e["over_bare"] for k, e in c["errors"].items()}}
            for (b, dt), c in checks.items()},
        "own_inputs_worst_reading": own_r,
        "compiled": compiled,
        "deepseek_step_2x2048": {"wall_ms": prof["wall_s"] * 1e3,
                                 "kernel_ms": busy,
                                 "bwd_ms": prof["bwd_ms"],
                                 "fwd_ms": prof["fwd_ms"],
                                 "peak_gib": prof["peak"] / 2 ** 30}}
    return row, launches


def main():
    t_all = time.monotonic()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap} < 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]} "
          f"x{torch.cuda.device_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; f32 matmuls in full f32 (TF32 off)")
    print(smi)

    # 2. build
    t = time.monotonic()
    secs = build.build_all(verbose=True)
    print(f"[build] {secs} ({time.monotonic() - t:.1f}s wall)")
    compiled = prompt_kernel_report()
    decode_compiled = decode_kernel_report()
    composed_compiled = composed_kernel_report()
    # 3. kernels
    worst, timings = {}, {}
    for name, phase in (("ragged_decode", phase_ragged),
                        ("fused_decode", phase_fused),
                        ("approx_score", phase_approx),
                        ("gather_attention", phase_gather),
                        ("flash_prefill", phase_flash)):
        t = time.monotonic()
        print(f"[kernels] {name} vs plain (out atol {OUT_ATOL}, probs atol "
              f"{PROBS_ATOL}; gather_attention atol {GATHER_ATOL}; "
              "approx_score bit for bit; flash_prefill out atol "
              f"{FLASH_OUT_ATOL}, acc rtol {FLASH_ACC_RTOL} with f32 "
              f"probabilities, {FLIP_ACC_RTOL:.4g} with bf16-rounded ones)")
        worst[name], timings[name] = phase()
        print(f"[kernels] {name} done in {time.monotonic() - t:.1f}s")
    t = time.monotonic()
    print(f"[kernels] the decode kernels' long route vs plain (out atol "
          f"{OUT_ATOL}, probs atol {PROBS_ATOL}, winner sets exact, two "
          "launches bit-equal)")
    long_worst, long_times = phase_long_kernels()
    worst.update(long_worst)
    print(f"[kernels] long route done in {time.monotonic() - t:.1f}s")
    t = time.monotonic()
    print("[kernels] the decode kernels' sharded route on one rank's block "
          "(held to the unsharded kernels in [mesh] and [slots])")
    shard_t = shard_times()
    print(f"[kernels] sharded route done in {time.monotonic() - t:.1f}s")

    # 8d (long_500k) and 8e. granite-3-2b at long_500k, unsharded and then
    # laid out over a 4-rank world, run while this process holds nothing:
    # the four ranks share its card under gloo
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    counted, long_step = phase_long_500k(smi)
    launches = dict.fromkeys(launch_counts(), 0)
    for name, n in counted.items():
        launches[name] += n
    print(f"[long] long_500k phase {time.monotonic() - t:.1f}s")
    counted, shard_err, mesh_ranks, mesh_s = phase_slots(smi)
    shard_worst = {"ragged_decode_shard": shard_err}
    for name, n in counted.items():
        launches[name] += n
    # 8c. the collective paths, run in [slots]' world
    t = time.monotonic()
    counted, mesh_err = phase_mesh(mesh_ranks, smi)
    for name, n in counted.items():
        launches[name] += n
    shard_worst["fused_decode_shard"] = mesh_err["fused_decode_shard"]
    shard_worst["ragged_decode_shard"] = max(
        shard_err, mesh_err["ragged_decode_shard"])
    print(f"[mesh] phase {mesh_s + time.monotonic() - t:.1f}s (in [slots]' "
          f"world)")
    for name, kernels in (("approx_score",
                           ("approx_score_mma_kernel<16, false>",)),
                          ("approx_score_packed",
                           ("approx_score_mma_kernel<16, true>",)),
                          ("gather_attention",
                           tuple(n for n in SERVED_COMPOSED
                                 if n.startswith("gather")))):
        timings["approx_score" if name.startswith("approx") else name][
            f"extra:{name}"]["compiled"] = {
                n: composed_compiled[n] for n in kernels
                if n in composed_compiled}
    timings["flash_prefill"]["extra"].update(compiled)
    for name in ("ragged_decode", "fused_decode"):
        warm, wall = timings[name]["bfloat16 warm"]
        timings[name]["extra"] = {
            "ms_l2_warm": warm, "call_ms": wall,
            "int8": dict(zip(("ms", "plain_ms", "bound_ms"),
                             timings[name]["int8"][:3]),
                         ms_l2_warm=timings[name]["int8 warm"][0]),
            "starcoder2_g12": timings[name]["g12"],
            "zamba2_d112": timings[name]["d112"],
            "whisper_d64": timings[name]["d64"],
            **decode_compiled.get(name, {})}

    # 4 + 5. full-width longchat-7b, global then block-local selection
    t = time.monotonic()
    cfg = get_config("longchat-7b")
    init_model = Model(cfg, baselines.unicaim(heavy=1024, reserve=64,
                                              select_k=128), device="cuda")
    params = init_model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[serve] longchat-7b random bf16 weights: {n_params} params, "
          f"made on the card in {time.monotonic() - t:.1f}s")
    watch_plain_prompt_attention()
    one_shard = {}                     # phase 4's streams, for [sharded]
    step_ms = {}                       # (kv, blocks) → decode step's ms
    for blocks in (1, 4):
        for kv in ("bf16", "int8"):
            tag = f"kv={kv} select_blocks={blocks}"
            t = time.monotonic()
            kernel, n, flash, model, whole, _ = phase_serve(cfg, params, kv,
                                                            smi, blocks)
            one_shard[(kv, blocks)] = [h.tokens for h in whole]
            launches[kernel] += n
            launches["flash_prefill"] += flash
            print(f"[serve] {tag} phase {time.monotonic() - t:.1f}s")
            if blocks == 1 and kv == "bf16":
                t = time.monotonic()
                phase_teacher(cfg, params, model)
                print(f"[serve] {tag} teacher-forced phase "
                      f"{time.monotonic() - t:.1f}s")
                t = time.monotonic()
                _, n, flash, cmodel, sliced, _ = phase_serve(
                    cfg, params, kv, smi, blocks, chunk=CHUNK)
                launches["ragged_decode"] += n
                launches["flash_prefill"] += flash
                phase_chunked(cfg, params, cmodel, whole, sliced, CHUNK)
                del cmodel
                print(f"[serve] {tag} chunk_prefill={CHUNK} phase "
                      f"{time.monotonic() - t:.1f}s")
                t = time.monotonic()
                prompt_ms = phase_prefill_profile(cfg, params, model)
                print(f"[profile] prompt pass phase "
                      f"{time.monotonic() - t:.1f}s")
            t = time.monotonic()
            st, tok, small = phase_paths(cfg, params, model)
            for name, n in small.items():
                launches[name] += n
            print(f"[paths] {tag} phase {time.monotonic() - t:.1f}s")
            t = time.monotonic()
            step_ms[(kv, blocks)] = phase_profile(params, model, st, tok)
            del st, model
            print(f"[profile] {tag} phase {time.monotonic() - t:.1f}s")

    # the tooling layer: the dry run's count and bounds against phase 4
    t = time.monotonic()
    phase_dryrun(cfg, params, smi, step_ms, prompt_ms)
    print(f"[dryrun] phase {time.monotonic() - t:.1f}s")

    # 6. the prefix cache, cold and warm; bf16 with half the new tokens,
    # int8 with a quarter (the prompt passes, hits and splices are the same)
    for kv, new in (("bf16", NEW_TOKENS // 2), ("int8", NEW_TOKENS // 4)):
        t = time.monotonic()
        for name, n in phase_prefix(cfg, params, kv, smi, new).items():
            launches[name] += n
        gc.collect()    # trie nodes point at their parents: free ~10 GB
        print(f"[prefix] kv={kv} phase {time.monotonic() - t:.1f}s")

    # 7. per-lane knobs, a preemption and reservation
    for kv in ("bf16", "int8"):
        t = time.monotonic()
        for name, n in phase_perlane(cfg, params, kv, smi).items():
            launches[name] += n
        gc.collect()
        print(f"[perlane] kv={kv} phase {time.monotonic() - t:.1f}s")

    # 8. fault tolerance: quarantine and retry, deadlines, cancellation,
    # backpressure, the degrade ladder
    t = time.monotonic()
    for name, n in phase_faults(cfg, params, smi).items():
        launches[name] += n
    print(f"[faults] phase {time.monotonic() - t:.1f}s")

    # 8b. the lane-sharded ServeLoop on the same weights
    t = time.monotonic()
    for name, n in phase_sharded(cfg, params, smi, one_shard).items():
        launches[name] += n
    print(f"[sharded] phase {time.monotonic() - t:.1f}s")
    # the loops of phase 4 (their handles) go before the long caches
    del whole, sliced
    gc.collect()
    torch.cuda.empty_cache()

    # 8d. long-context decode: longchat-7b at decode_32k, granite-3-2b at
    # long_500k, on the decode kernels' long route
    t = time.monotonic()
    counted, long_agg = phase_long_served(cfg, params, smi)
    for name, n in counted.items():
        launches[name] += n
    print(f"[long] decode_32k phase {time.monotonic() - t:.1f}s")
    # longchat-7b's weights go before the next model is made
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[family] before phase 9: {held / 2 ** 30:.3f} GiB still "
          f"allocated on the card (longchat-7b's 13.5 GB freed)")
    assert held < 1 << 30, held


    # 9. the rest of the dense family and the MoE family, full width
    t = time.monotonic()
    for name, n in phase_family(smi).items():
        launches[name] += n
    print(f"[family] phase {time.monotonic() - t:.1f}s")

    # 10. MLA and the mla_moe family: deepseek-v3-671b, 5 layers
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[mla] before phase 10: {held / 2 ** 30:.3f} GiB still allocated "
          f"on the card (phase 9's models freed)")
    assert held < 1 << 30, held
    t = time.monotonic()
    mla_launches, survey = phase_mla(smi)
    for name, n in mla_launches.items():
        launches[name] += n
    timings["flash_prefill"]["extra"]["latent"].update(
        launches=mla_launches["flash_prefill"], phase10=survey)
    print(f"[mla] phase {time.monotonic() - t:.1f}s")

    # 11. Mamba2 SSD blocks: mamba2-1.3b and zamba2-7b, full width and depth
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[ssm] before phase 11: {held / 2 ** 30:.3f} GiB still allocated "
          f"on the card (phase 10's model freed)")
    assert held < 1 << 30, held
    t = time.monotonic()
    ssm_launches = phase_ssm(smi)
    for name, n in ssm_launches.items():
        launches[name] += n
    for name in ("ragged_decode", "fused_decode", "flash_prefill"):
        timings[name]["extra"]["zamba2_launches"] = ssm_launches[name]
    print(f"[ssm] phase {time.monotonic() - t:.1f}s")

    # 12. the enc-dec family: whisper-base, full width and depth
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[encdec] before phase 12: {held / 2 ** 30:.3f} GiB still "
          f"allocated on the card (phase 11's models freed)")
    assert held < 1 << 30, held
    t = time.monotonic()
    encdec_launches = phase_encdec(smi)
    for name, n in encdec_launches.items():
        launches[name] += n
    for name in ("ragged_decode", "fused_decode", "flash_prefill"):
        timings[name]["extra"]["whisper_launches"] = encdec_launches[name]
    print(f"[encdec] phase {time.monotonic() - t:.1f}s")

    # 13. training: the attention backward kernel, granite-3-2b and
    # whisper-base at full width and depth
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[train] before phase 13: {held / 2 ** 30:.3f} GiB still "
          f"allocated on the card (phase 12's model freed)")
    assert held < 1 << 30, held
    bwd_row, train_launches, latent_compiled = phase_train(smi)
    for name, n in train_launches.items():
        launches[name] += n
    timings["flash_prefill"]["extra"]["train_launches"] = train_launches[
        "flash_prefill"]

    # 14. MLA training: the latent route of the attention backward and
    # deepseek-v3-671b's dense blocks and MTP head
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[mla-train] before phase 14: {held / 2 ** 30:.3f} GiB still "
          f"allocated on the card (phase 13's models freed)")
    assert held < 1 << 30, held
    lat_bwd_row, mla_train_launches = phase_mla_train(smi, latent_compiled)
    for name, n in mla_train_launches.items():
        launches[name] += n
    assert all(launches.values()), launches

    rows = [  # name, source, TPU entry it replaces, timing key, error key
        ("ragged_decode", "ragged_decode.cu", "ragged_decode.py:167",
         "bfloat16", "ragged_decode"),
        ("fused_decode", "fused_decode.cu", "fused_decode.py:173",
         "bfloat16", "fused_decode"),
        ("approx_score", "approx_score.cu", "approx_score.py:96",
         "approx_score", "approx_score"),
        ("approx_score_packed", "approx_score.cu", "approx_score.py:67",
         "approx_score_packed", "approx_score"),
        ("gather_attention", "gather_attention.cu", "gather_attention.py:59",
         "gather_attention", "gather_attention"),
        ("flash_prefill", "flash_prefill.cu", "flash_prefill.py:105",
         "bfloat16", "flash_prefill"),
    ]
    table = []
    for name, src, tpu, key, err in rows:
        phase = "approx_score" if name.startswith("approx") else name
        ms, plain, t_bound, by, lib = timings[phase][key]
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": launches[name], "max_abs_err": worst[err], "ms": ms,
            "plain_ms": plain, "bound_ms": t_bound, "bound_by": by,
            "library_ms": lib, **timings[phase].get(
                f"extra:{name}", timings[phase].get("extra", {}))})
    # the latent route: a kernel of its own behind the same wrapper (its
    # launches, phase 10's, are within flash_prefill's count too)
    lat = timings["flash_prefill"]["extra"]["latent"]
    b4 = lat["served_B4"]
    table.append({
        "name": "flash_prefill_latent", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:105",
        "launches": lat["launches"], "max_abs_err": lat["max_abs_err"],
        "ms": b4["ms"], "plain_ms": b4["plain_ms"],
        "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
        "library_ms": b4["library_ms"]})
    # the decode kernels' long route: a kernel pair of its own behind each
    # wrapper, timed at longchat-7b's decode_32k with bf16 K/V
    for name, tpu in (("ragged_decode_long", "ragged_decode.py:167"),
                      ("fused_decode_long", "fused_decode.py:173")):
        main_t = long_times[name]["longchat-7b decode_32k bfloat16"]
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_long.cuh",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": launches[name], "max_abs_err": max(
                worst[name], long_step["layer0_max_abs_err"]),
            "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": None, "shapes": long_times[name],
            "decode_32k_served": {k: long_agg[k] for k in (
                "tokens", "tokens_per_s", "p50_ttft_s", "p99_ttft_s")},
            "long_500k_step": {k: v for k, v in long_step.items()
                               if k.endswith("_ms")},
            **decode_compiled.get(name, {})})
    # the decode kernels' sharded route: the long route's kernels, a stage
    # a launch, on a rank's block of a slot-split cache
    for name, tpu in (("ragged_decode_shard", "ragged_decode.py:167"),
                      ("fused_decode_shard", "fused_decode.py:173")):
        main_t = shard_t[name][SHARD_SHAPES[0][0]]
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_long.cuh",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": launches[name], "max_abs_err": shard_worst[name],
            "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": None, "shapes": shard_t[name]})
    table.append(bwd_row)
    table.append(lat_bwd_row)
    print(json.dumps({"kernels": table}))
    print(f"[done] {time.monotonic() - t_all:.1f}s total")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list)):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
