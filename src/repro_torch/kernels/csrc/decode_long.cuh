// The long route of the fused pruned-decode kernels (ragged_decode.cu,
// fused_decode.cu): the same function as decode_row at any slot count,
// with no shared-memory size that grows with S. decode_row keeps a row's
// [G][S] scores and [S] keys in one CTA's shared memory, which caps S
// (22,640 slots at G = 1, d = 128; 3,957 at G = 12); a long cache
// (decode_32k: S = 32,768, select_k = 2,048; long_500k: S = 524,288) takes
// this route instead, which the wrapper picks where decode_row's layout
// does not fit.
//
// Bound. As decode_row's: the live mirror rows with their scale, valid and
// protection bytes, the valid winners' K/V rows and scales, probs written
// once. A decode_32k step of longchat-7b (32 rows a lane) reads about 187
// MB a lane with bf16 K/V, 0.056 ms at 3.35 TB/s. Each row streams 4.2 MB
// of mirror there (33.5 MB at long_500k), so one CTA a row would leave
// most of the 132 SMs idle; the route splits a row over CTAs in three
// kernels:
//   1. long_score_kernel, a grid of (slot chunk, row) CTAs: each streams
//      its chunk's live mirror rows through decode_row's TMA ring and
//      scores them as decode_row does (the same integer dot, the same
//      rounding, the G-row sum in row order), and writes to the wrapper's
//      scratch: the per-g scores of its live slots, the selection key of
//      every slot (PROT_WIN at protected slots, the G-row sum of NEG_INF at
//      dead ones), each g's (max, sum of exp) over the chunk's valid slots,
//      and its count of the keys' top bytes, added into the row's
//      histogram (one a selection block).
//   2. long_race_kernel, a cluster of kCluster CTAs a row: the radix select
//      of select_topk, over the keys in device memory, each CTA counting a
//      slice of the selection block into its own histogram and every CTA
//      summing the cluster's through distributed shared memory (one
//      cluster barrier a pass); the winners are written in select_topk's
//      order (the slots above the k-th key in slot order, then the
//      lowest-index slots equal to it), so the winner set is decode_row's.
//      Then each CTA attends over its share of the winners in staged
//      chunks with an online softmax (decode_row's logits and p·v bodies),
//      and the cluster's partials are merged in rank order; rank 0 merges
//      the score kernel's (max, sum) of each g over the row.
//   3. long_probs_kernel, the score kernel's grid again: probs over each
//      chunk from the scores and the merged (max, sum), so the row's G·S
//      scores stream back at the card's rate rather than a cluster's.
//   Every sum runs in a fixed order: two launches are bit-equal.
//
// The sharded route (`LaunchShard`) runs the same kernels one stage a
// launch on one rank's block of a cache whose slots are split over ranks;
// the wrapper runs the collectives between the launches (torch.distributed
// on its stream). The race kernel takes a mode (`X.mode`): race, write the
// candidates of a global race (each winner's key and global slot), attend
// over picks written before it, write the attention's partials (max,
// denominator, unnormalised p·v) in place of out, and merge the score
// kernel's (max, sum) into X.mz. `shard_merge_kernel` races the ranks'
// gathered candidates for the global winners.

#pragma once

#include <cooperative_groups.h>

#include "decode_common.cuh"

namespace decode {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;            // CTAs a row in the race kernel
constexpr int kLongRing = 48 * 1024;   // score kernel's mirror ring
constexpr int kChunkMax = 2048;        // slots a score CTA takes, at most
constexpr int kChunkWords = 8192;      // [G][chunk] f32 scores, at most
constexpr int kLongCap = 128;          // winners a race CTA stages at once

// The race kernel's stages (bits of Scratch::mode).
constexpr int kRace = 1;      // race the keys into picks
constexpr int kCand = 2;      // write the picks' (key, global slot)
constexpr int kAttend = 4;    // attend over the valid picks of this block
constexpr int kPartial = 8;   // write (max, den) and Σ p·v, not out
constexpr int kMz = 16;       // merge the score kernel's (max, sum) into mz
constexpr int kWhole = kRace | kAttend | kMz;  // the unsharded long route

// Slots a score CTA takes at G query rows: kChunkMax, halved until its
// [G][chunk] scores fit kChunkWords (at least 512 at G <= 16). The shared
// memory is sized for this; the chunk run is min(this, S / num_blocks),
// so a chunk spans at most two selection blocks.
__host__ __device__ inline int long_chunk(int G) {
  int c = kChunkMax;
  while (c > 256 && c * G > kChunkWords) c >>= 1;
  return c;
}

// The wrapper's device scratch for one launch: byte offsets and sizes.
struct Scratch {
  float* sc;       // [BH][G][Sp] scores of live slots
  uint32_t* key;   // [BH][Sp] selection keys
  float2* part;    // [BH][nch][G] (max of score/sqrt(d), sum of exp) a chunk
  int* hist;       // [BH][num_blocks][256] top-byte counts (zeroed first)
  int* picks;      // [BH][select_k] winners, in select_topk's order
  float2* mz;      // [BH][G] (max, sum of exp) of each g over the row
  int2* cand;      // sharded: [BH][select_k] (key, global slot) of the picks
  float2* opart;   // sharded: [BH][G] (max, den) of the attention partials
  int Sp, ch, nch;
  int mode;        // the race kernel's stages (kRace, ...)
  int offset;      // sharded: the block's first global slot
  size_t hist_bytes;
};

// Carve `base` (or, with base == nullptr, only count) into a Scratch;
// returns its bytes. Sp pads a row of keys to 16 bytes, so the race reads
// them in 16-byte words. `shard` adds the sharded route's candidates and
// partials; `offs`, if given, takes the byte offsets of cand, mz, opart
// and picks.
inline size_t long_scratch(int BH, int S, int G, int num_blocks,
                           int select_k, unsigned char* base, Scratch* x,
                           bool shard = false, size_t* offs = nullptr) {
  const int Sp = (S + 3) & ~3;
  const int bs = S / num_blocks;
  const int ch = long_chunk(G) < bs ? long_chunk(G) : bs;
  const int nch = (S + ch - 1) / ch;
  size_t at = 0;
  const size_t sc = take(at, 4 * (size_t)BH * G * Sp);
  const size_t key = take(at, 4 * (size_t)BH * Sp);
  const size_t part = take(at, 8 * (size_t)BH * nch * G);
  const size_t hist = take(at, 4 * 256 * (size_t)BH * num_blocks);
  const size_t picks = take(at, 4 * (size_t)BH * select_k);
  const size_t mz = take(at, 8 * (size_t)BH * G);
  const size_t cand = shard ? take(at, 8 * (size_t)BH * select_k) : 0;
  const size_t opart = shard ? take(at, 8 * (size_t)BH * G) : 0;
  if (offs != nullptr) {
    offs[0] = cand;
    offs[1] = mz;
    offs[2] = opart;
    offs[3] = picks;
  }
  if (x != nullptr) {
    x->sc = reinterpret_cast<float*>(base + sc);
    x->key = reinterpret_cast<uint32_t*>(base + key);
    x->part = reinterpret_cast<float2*>(base + part);
    x->hist = reinterpret_cast<int*>(base + hist);
    x->picks = reinterpret_cast<int*>(base + picks);
    x->mz = reinterpret_cast<float2*>(base + mz);
    x->cand = shard ? reinterpret_cast<int2*>(base + cand) : nullptr;
    x->opart = shard ? reinterpret_cast<float2*>(base + opart) : nullptr;
    x->Sp = Sp;
    x->ch = ch;
    x->nch = nch;
    x->mode = kWhole;
    x->offset = 0;
    x->hist_bytes = 4 * 256 * (size_t)BH * num_blocks;
  }
  return at;
}

// The live slot count of a row: ragged_decode's fill rounded up to the
// skip block, fused_decode's S.
__device__ __forceinline__ int row_live(const Params& P, int row) {
  if (P.fills == nullptr) return P.S;
  const int fill = min(max(P.fills[row], 0), P.S);
  return min((fill + P.block_s - 1) / P.block_s * P.block_s, P.S);
}

// ---------------------------------------------------------------------------
// 1. the score kernel
// ---------------------------------------------------------------------------

struct ScoreLayout {
  size_t sc, ms, ok, pr, qq, qs, hist, red, bars, ring, total;
  int ts;  // slots per ring tile
};

// Shared memory of one score CTA: nothing grows with S.
__host__ __device__ inline ScoreLayout score_layout(int G, int d) {
  ScoreLayout m;
  const int ch = long_chunk(G);
  size_t at = 0;
  m.sc = take(at, 4 * (size_t)G * ch);
  m.ms = take(at, 4 * (size_t)ch);
  m.ok = take(at, (size_t)ch);
  m.pr = take(at, (size_t)ch);
  m.qq = take(at, (size_t)G * d);
  m.qs = take(at, 4 * (size_t)G);
  m.hist = take(at, 4 * 2 * 256);
  m.red = take(at, 4 * (size_t)kWarps);
  m.bars = take(at, 8 * (size_t)kStages);
  m.ring = at;
  const int ts = kLongRing / (kStages * d);
  m.ts = ts < 1 ? 1 : ts > kThreads ? kThreads : ts;
  m.total = at + (size_t)kStages * m.ts * d;
  return m;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    long_score_kernel(const Params P, const Scratch X) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = P.S, G = P.G, d = P.d;
  const ScoreLayout L = score_layout(G, d);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* ms = reinterpret_cast<float*>(smem + L.ms);
  int8_t* ok = reinterpret_cast<int8_t*>(smem + L.ok);
  int8_t* pr = reinterpret_cast<int8_t*>(smem + L.pr);
  int* qq = reinterpret_cast<int*>(smem + L.qq);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  unsigned char* ring = smem + L.ring;

  const int tid = threadIdx.x;
  const int row = blockIdx.y, ch = X.ch;
  const int c0 = blockIdx.x * ch, n = min(ch, S - c0);
  const int live = row_live(P, row);
  const int nl = max(0, min(n, live - c0));  // live slots of this chunk
  const size_t rs = (size_t)row * S;
  const int8_t* mir = P.mirror + (rs + c0) * d;
  const int ts = L.ts;
  const int ntiles = (nl + ts - 1) / ts;
  const int bs = S / P.num_blocks, b0 = c0 / bs;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  if constexpr (VEC == 16)
    for (int t = 0; t < kStages - 1; ++t)
      fetch_tile<VEC>(ring, mir, t, ts, nl, d, bars);
  __syncthreads();
  copy_to_smem(qq, P.qq + (size_t)row * G * d, G * d);
  copy_to_smem(qs, P.qscale + (size_t)row * G, 4 * G);
  copy_to_smem(ms, P.mscale + rs + c0, 4 * nl);
  copy_to_smem(ok, P.valid + rs + c0, nl);
  copy_to_smem(pr, P.prot + rs + c0, n);
  for (int t = 0; t < kStages - 1; ++t) {
    if constexpr (VEC != 16) fetch_tile<VEC>(ring, mir, t, ts, nl, d, bars);
    cp_async_commit();
  }
  for (int i = tid; i < 2 * 256; i += kThreads) hist[i] = 0;
  uint32_t* key = X.key + (size_t)row * X.Sp + c0;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    if constexpr (VEC == 16) mbar_wait(bars + t % kStages, (t / kStages) & 1);
    __syncthreads();
    fetch_tile<VEC>(ring, mir, t + kStages - 1, ts, nl, d, bars);
    cp_async_commit();
    const int j = t * ts + tid;
    if (tid < min(ts, nl - t * ts)) {
      const unsigned char* r = ring + (size_t)(t % kStages) * ts * d +
                               (size_t)tid * d;
      const bool valid = ok[j] != 0;
      float sum = 0.f;
      for (int g = 0; g < G; ++g) {
        const int dot = slot_dot<VEC>(r, qq + g * (d >> 2), tid, d);
        const float x =
            valid ? __fmul_rn(__fmul_rn((float)dot, qs[g]), ms[j]) : kNegInf;
        sc[g * ch + j] = x;
        sum = g == 0 ? x : __fadd_rn(sum, x);
      }
      const uint32_t k = order_key(pr[j] != 0 ? kProtWin : sum);
      key[j] = k;
      atomicAdd(&hist[256 * ((c0 + j) / bs - b0) + (k >> 24)], 1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float dead = kNegInf;  // the G-row sum of a slot that is not scored
  for (int g = 1; g < G; ++g) dead = __fadd_rn(dead, kNegInf);
  for (int j = nl + tid; j < n; j += kThreads) {
    const uint32_t k = order_key(pr[j] != 0 ? kProtWin : dead);
    key[j] = k;
    atomicAdd(&hist[256 * ((c0 + j) / bs - b0) + (k >> 24)], 1);
  }
  __syncthreads();
  for (int i = tid; i < 2 * 256; i += kThreads) {
    const int b = b0 + i / 256;
    if (hist[i] != 0 && b < P.num_blocks)
      atomicAdd(&X.hist[((size_t)row * P.num_blocks + b) * 256 + i % 256],
                hist[i]);
  }
  // the scores to the scratch, and each g's (max, sum of exp) over the
  // chunk's valid slots (max -inf and sum 0 where it has none)
  float2* part = X.part + ((size_t)row * X.nch + blockIdx.x) * G;
  for (int g = 0; g < G; ++g) {
    const float* sg = sc + g * ch;
    float* out = X.sc + ((size_t)row * G + g) * X.Sp + c0;
    float mx = -INFINITY;
    for (int j = tid; j < nl; j += kThreads) {
      const float x = sg[j];
      out[j] = x;
      if (x > 0.5f * kNegInf) mx = fmaxf(mx, __fmul_rn(x, P.scale));
    }
    mx = block_reduce(mx, red, true);
    float z = 0.f;
    if (mx > -INFINITY)
      for (int j = tid; j < nl; j += kThreads) {
        const float x = sg[j];
        if (x > 0.5f * kNegInf) z += expf(__fmul_rn(x, P.scale) - mx);
      }
    z = block_reduce(z, red, false);
    if (tid == 0) part[g] = make_float2(mx, z);
  }
}

// ---------------------------------------------------------------------------
// 2. the race kernel
// ---------------------------------------------------------------------------

struct RaceLayout {
  size_t hist, mhist, sel, scan, red, cnt, misc, stat, acc, qf, win, wks,
      wvs, plog, part, bars, stage, total;
  int cap;  // winner rows staged at once
  int k_stride, v_stride;
};

// Shared memory of one race CTA: nothing grows with S or select_k.
__host__ __device__ inline RaceLayout race_layout(int G, int d, int dv,
                                                  int elt) {
  RaceLayout m;
  size_t at = 0;
  m.hist = take(at, 4 * 2 * 256);  // two, used in turn by the passes
  m.mhist = take(at, 4 * 256);
  m.sel = take(at, 16);
  m.scan = take(at, 4 * 2 * (size_t)kWarps);
  m.red = take(at, 4 * (size_t)kWarps);
  m.cnt = take(at, 16);
  m.misc = take(at, 16);
  m.stat = take(at, 4 * 3 * (size_t)kMaxG);  // m, l, alpha
  m.acc = take(at, 4 * (size_t)G * dv);
  m.qf = take(at, 4 * (size_t)G * d);
  m.win = take(at, 4 * (size_t)kLongCap);
  m.wks = take(at, 4 * (size_t)kLongCap);
  m.wvs = take(at, 4 * (size_t)kLongCap);
  m.plog = take(at, 4 * (size_t)G * kLongCap);
  m.part = take(at, 4 * (size_t)kThreads);
  m.bars = take(at, 16);
  m.stage = at;
  m.k_stride = (int)align16((size_t)d * elt) + 16;
  m.v_stride = (int)align16((size_t)dv * elt) + 16;
  const size_t pair = (size_t)m.k_stride + m.v_stride;
  const size_t room = kSmemMax > at ? kSmemMax - at : 0;
  const size_t fit = room / pair;
  m.cap = fit < (size_t)kLongCap ? (fit < 1 ? 1 : (int)fit) : kLongCap;
  m.total = at + (size_t)m.cap * pair;
  return m;
}

// Sum of v over the CTA, into every thread (red holds kWarps ints).
__device__ __forceinline__ int block_sum_int(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  return r;
}

// The four keys key[s4, s4 + 4) (s4 % 4 == 0, inside the padded row).
__device__ __forceinline__ uint4 keys4(const uint32_t* key, int s4) {
  return __ldcg(reinterpret_cast<const uint4*>(key + s4));
}

__device__ __forceinline__ uint32_t lane_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// select_topk over key[lo, hi) by the cluster: the k largest keys, ties to
// the lower slot, into out[0, k) in select_topk's order. This CTA counts
// key[a, b), its slice; `ghist` holds the first pass's counts (the score
// kernel's). Ends with every CTA's winners written (the caller fences and
// synchronises the cluster before reading them).
__device__ void cluster_select(const cg::cluster_group& cl,
                               const uint32_t* key, int lo, int hi, int k,
                               const int* ghist, int* hist, int* mhist,
                               int* sel, int* scan, int* cnt, int* red,
                               int* out) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rank = (int)cl.block_rank();
  const long n = hi - lo;
  const int a = lo + (int)(n * rank / kCluster);
  const int b = lo + (int)(n * (rank + 1) / kCluster);
  const int a4 = a & ~3;
  for (int i = tid; i < 256; i += kThreads) mhist[i] = ghist[i];
  __syncthreads();
  if (warp == 0) find_bin(mhist, k, sel);
  __syncthreads();
  uint32_t prefix = static_cast<uint32_t>(sel[0]) << 24, mask = 0xff000000u;
  int rem = sel[1];
  for (int shift = 16, turn = 0; shift >= 0; shift -= 8, turn ^= 1) {
    // the buffer zeroed here was last read by the other CTAs before the
    // previous pass's cluster barrier
    int* h = hist + 256 * turn;
    for (int i = tid; i < 256; i += kThreads) h[i] = 0;
    __syncthreads();
    for (int s4 = a4 + 4 * tid; s4 < b; s4 += 4 * 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = s4 + u * 4 * kThreads;
        v[u] = t < b ? keys4(key, t) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s4 + u * 4 * kThreads + i;
          const uint32_t x = lane_of(v[u], i);
          if (s >= a && s < b && (x & mask) == prefix)
            atomicAdd(&h[(x >> shift) & 255u], 1);
        }
    }
    cl.sync();
    for (int i = tid; i < 256; i += kThreads) {
      int c = 0;
      for (int r = 0; r < kCluster; ++r) c += cl.map_shared_rank(h, r)[i];
      mhist[i] = c;
    }
    __syncthreads();
    if (warp == 0) find_bin(mhist, rem, sel);
    __syncthreads();
    prefix |= static_cast<uint32_t>(sel[0]) << shift;
    mask |= 255u << shift;
    rem = sel[1];
  }
  // prefix is the k-th key; the slots above it win, and the rem
  // lowest-index slots equal to it. First this slice's counts, then the
  // slices before it give its offsets.
  int gt = 0, eq = 0;
  for (int s4 = a4 + 4 * tid; s4 < b; s4 += 4 * kThreads) {
    const uint4 v = keys4(key, s4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s4 + i;
      const uint32_t x = lane_of(v, i);
      gt += s >= a && s < b && x > prefix;
      eq += s >= a && s < b && x == prefix;
    }
  }
  gt = block_sum_int(gt, red);
  eq = block_sum_int(eq, red);
  if (tid == 0) {
    cnt[0] = gt;
    cnt[1] = eq;
  }
  cl.sync();
  int at_gt = 0, at_eq = 0;
  for (int r = 0; r < rank; ++r) {
    const int* c = cl.map_shared_rank(cnt, r);
    at_gt += c[0];
    at_eq += c[1];
  }
  const int n_gt = k - rem, end_gt = at_gt + gt, end_eq = at_eq + eq;
  // the slice in tiles of 4 keys a thread, four tiles' loads in flight,
  // each tile's winners ranked in slot order by a CTA scan
  const CtaGroup grp{scan};
  for (int s4 = a4; s4 < b; s4 += 4 * 4 * kThreads) {
    if (at_gt == end_gt && (at_eq >= rem || at_eq == end_eq)) break;
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = s4 + u * 4 * kThreads + 4 * tid;
      v[u] = t < b ? keys4(key, t) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = s4 + u * 4 * kThreads + 4 * tid;
      int g = 0, e = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = t + i;
        const uint32_t x = lane_of(v[u], i);
        g += s >= a && s < b && x > prefix;
        e += s >= a && s < b && x == prefix;
      }
      // a tile with no winner is skipped: its eq slots are none, or not
      // needed (at_eq >= rem already)
      if (!__syncthreads_or(g > 0 || (at_eq < rem && e > 0))) continue;
      int og, oe;
      grp.scan2(g, e, og, oe);
      int tot_g = 0, tot_e = 0;
      for (int w = 0; w < kWarps; ++w) {
        tot_g += scan[w];
        tot_e += scan[kWarps + w];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = t + i;
        const uint32_t x = lane_of(v[u], i);
        if (s < a || s >= b) continue;
        if (x > prefix) {
          out[at_gt + og++] = s;
        } else if (x == prefix) {
          if (at_eq + oe < rem) out[n_gt + at_eq + oe] = s;
          ++oe;
        }
      }
      at_gt += tot_g;
      at_eq += tot_e;
    }
  }
}

template <typename KV>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    long_race_kernel(const Params P, const Scratch X) {
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cl = cg::this_cluster();
  const int S = P.S, G = P.G, d = P.d, dv = P.dv, K = P.select_k;
  const int nb = P.num_blocks, bs = S / nb, kl = K / nb;
  const RaceLayout L = race_layout(G, d, dv, (int)sizeof(KV));
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* mhist = reinterpret_cast<int*>(smem + L.mhist);
  int* sel = reinterpret_cast<int*>(smem + L.sel);
  int* scan = reinterpret_cast<int*>(smem + L.scan);
  int* red = reinterpret_cast<int*>(smem + L.red);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  float *mg = stat, *lg = stat + kMaxG, *alpha = stat + 2 * kMaxG;
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* qf = reinterpret_cast<float*>(smem + L.qf);
  int* win = reinterpret_cast<int*>(smem + L.win);
  float* wks = reinterpret_cast<float*>(smem + L.wks);
  float* wvs = reinterpret_cast<float*>(smem + L.wvs);
  float* plog = reinterpret_cast<float*>(smem + L.plog);
  float* part = reinterpret_cast<float*>(smem + L.part);
  uint64_t* bar_k = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* bar_v = bar_k + 1;
  unsigned char* kst = smem + L.stage;
  unsigned char* vst = kst + (size_t)L.cap * L.k_stride;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cl.block_rank(), row = blockIdx.y;
  const int live = row_live(P, row);
  const size_t rs = (size_t)row * S;
  const uint32_t* key = X.key + (size_t)row * X.Sp;
  int* picks = X.picks + (size_t)row * K;

  if (tid == 0) {
    mbar_init(bar_k);
    mbar_init(bar_v);
    mbar_init_fence();
  }
  copy_to_smem(qf, P.q + (size_t)row * G * d, 4 * G * d);
  cp_async_commit();
  for (int x = tid; x < G * dv; x += kThreads) acc[x] = 0.f;
  if (tid < G) {
    mg[tid] = -INFINITY;
    lg[tid] = 0.f;
  }

  // -- 2. the race, one selection block after another -----------------------
  const int mode = X.mode;
  if (mode & kRace)
    for (int blk = 0; blk < nb; ++blk)
      cluster_select(cl, key, blk * bs, (blk + 1) * bs, kl,
                     X.hist + ((size_t)row * nb + blk) * 256, hist, mhist,
                     sel, scan, cnt, red, picks + (size_t)blk * kl);
  __threadfence();
  cl.sync();  // every CTA's winners are written

  // -- 3-5. this CTA's share of the picks: valid winners in pick order,
  //         staged cap at a time, online softmax across the chunks ----------
  const int p0 = (int)((long)K * rank / kCluster);
  const int p1 = (int)((long)K * (rank + 1) / kCluster);
  if (mode & kCand)  // the candidates of a global race: key, global slot
    for (int j = p0 + tid; j < p1; j += kThreads) {
      const int p = __ldcg(picks + j);
      X.cand[(size_t)row * K + j] = make_int2((int)key[p], p + X.offset);
    }
  const bool bulk_k = granule(d * (int)sizeof(KV)) == 16;
  const bool bulk_v = granule(dv * (int)sizeof(KV)) == 16;
  const KV* k_row = static_cast<const KV*>(P.k) + rs * d;
  const KV* v_row = static_cast<const KV*>(P.v) + rs * dv;
  int uses = 0;
  for (int c0 = (mode & kAttend) ? p0 : p1; c0 < p1; c0 += L.cap) {
    const int n = min(L.cap, p1 - c0);
    __syncthreads();  // the previous chunk's rows and winners are read
    if (warp == 0) {
      int nv = 0;
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const int p = j < n ? __ldcg(picks + c0 + j) : 0;
        const bool v = j < n && (unsigned)p < (unsigned)live &&
                       P.valid[rs + p] != 0;
        const unsigned vote = __ballot_sync(0xffffffffu, v);
        if (v) win[nv + __popc(vote & ((1u << lane) - 1u))] = p;
        nv += __popc(vote);
      }
      if (lane == 0) misc[0] = nv;
    }
    __syncthreads();
    const int nv = misc[0];
    if (nv == 0) continue;
    fetch_rows<KV>(kst, L.k_stride, k_row, d, win, nv, bar_k);
    fetch_rows<KV>(vst, L.v_stride, v_row, dv, win, nv, bar_v);
    for (int j = tid; j < nv; j += kThreads) {
      cp_async<4>(smem_u32(wks + j), P.kscale + rs + win[j]);
      cp_async<4>(smem_u32(wvs + j), P.vscale + rs + win[j]);
    }
    cp_async_commit();
    cp_async_wait<0>();
    if (bulk_k) mbar_wait(bar_k, uses & 1);
    if (bulk_v) mbar_wait(bar_v, uses & 1);
    ++uses;
    __syncthreads();
    winner_logits<KV>(kst, L.k_stride, qf, wks, plog, kLongCap, 0, nv, G, d,
                      P.scale);
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // online softmax, a warp a row
      float* pl = plog + g * kLongCap;
      float mx = -INFINITY;
      for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, pl[j]);
      mx = warp_max(mx);
      const float mo = mg[g], mn = fmaxf(mo, mx);
      float z = 0.f;
      for (int j = lane; j < nv; j += 32) {
        const float e = expf(pl[j] - mn);
        pl[j] = e;
        z += e;
      }
      z = warp_sum(z);
      if (lane == 0) {
        const float al = mo == -INFINITY ? 0.f : expf(mo - mn);
        alpha[g] = al;
        lg[g] = lg[g] * al + z;
        mg[g] = mn;
      }
    }
    __syncthreads();
    for (int x = tid; x < G * dv; x += kThreads) acc[x] *= alpha[x / dv];
    __syncthreads();
    winner_values<KV>(vst, L.v_stride, wvs, plog, kLongCap, part, acc, 0, nv,
                      G, dv, false);
  }
  cp_async_wait<0>();  // the query, where no chunk waited for it
  __syncthreads();

  // each g's (max, sum of exp) over the row, from the score kernel's
  // chunks, for the probs kernel
  if (rank == 0 && (mode & kMz)) {
    const float2* cp = X.part + (size_t)row * X.nch * G;
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int c = lane; c < X.nch; c += 32) mx = fmaxf(mx, cp[c * G + g].x);
      mx = warp_max(mx);
      float z = 0.f;
      if (mx > -INFINITY)
        for (int c = lane; c < X.nch; c += 32) {
          const float2 pz = cp[c * G + g];
          if (pz.x > -INFINITY) z += pz.y * expf(pz.x - mx);
        }
      z = warp_sum(z);
      if (lane == 0) X.mz[(size_t)row * G + g] = make_float2(mx, z);
    }
  }
  cl.sync();  // every CTA's attention partials are in its shared memory

  // -- the cluster's partials, merged in rank order by rank 0; with
  //    kPartial they are written as they are (max, den and Σ p·v) --------
  if (rank == 0 && (mode & kAttend)) {
    float* out_row = P.out + (size_t)row * G * dv;
    for (int x = tid; x < G * dv; x += kThreads) {
      const int g = x / dv;
      float mx = -INFINITY;
      for (int r = 0; r < kCluster; ++r)
        mx = fmaxf(mx, cl.map_shared_rank(mg, r)[g]);
      float num = 0.f, den = 0.f;
      if (mx > -INFINITY)
        for (int r = 0; r < kCluster; ++r) {
          const float m = cl.map_shared_rank(mg, r)[g];
          if (m == -INFINITY) continue;
          const float w = expf(m - mx);
          num += cl.map_shared_rank(acc, r)[x] * w;
          den += cl.map_shared_rank(lg, r)[g] * w;
        }
      if (mode & kPartial) {
        out_row[x] = num;
        if (x == g * dv) X.opart[(size_t)row * G + g] = make_float2(mx, den);
      } else {
        out_row[x] = mx > -INFINITY ? num / den : 0.f;
      }
    }
  }

  cl.sync();  // rank 0 has read every CTA's partials
}

// ---------------------------------------------------------------------------
// 3. the probs kernel
// ---------------------------------------------------------------------------

// probs[s] = Σ_g exp(score[g][s]/√d - M_g) / Z_g over one slot chunk of a
// row (a grid of (chunk, row) CTAs, as the score kernel's), exactly 0 at
// invalid and dead slots; (M_g, Z_g) are the race kernel's merge.
__global__ void __launch_bounds__(kThreads)
    long_probs_kernel(const Params P, const Scratch X) {
  __shared__ float M[kMaxG], Z[kMaxG];
  const int G = P.G, row = blockIdx.y, tid = threadIdx.x;
  const int c0 = blockIdx.x * X.ch, n = min(X.ch, P.S - c0);
  const int nl = max(0, min(n, row_live(P, row) - c0));
  if (tid < G) {
    const float2 mz = X.mz[(size_t)row * G + tid];
    M[tid] = mz.x;
    Z[tid] = fmaxf(mz.y, 1e-30f);
  }
  __syncthreads();
  float* probs = P.probs + (size_t)row * P.S + c0;
  const float* scr = X.sc + (size_t)row * G * X.Sp + c0;
#pragma unroll 4
  for (int j = tid; j < n; j += kThreads) {
    float p = 0.f;
    if (j < nl)
      for (int g = 0; g < G; ++g) {
        const float x = __ldcs(scr + (size_t)g * X.Sp + j);
        const float ex =
            x > 0.5f * kNegInf ? expf(__fmul_rn(x, P.scale) - M[g]) : 0.f;
        p = (g == 0 ? 0.f : p) + ex / Z[g];
      }
    probs[j] = p;
  }
}

// Launch the long route on `stream`: zero the histograms, score, race,
// probs.
// run() returns the CUDA error (0 on success); by_kind dispatches to it.
template <int VEC, typename KV>
struct LaunchLong {
  static int run(const Params& p, int BH, void* scratch,
                 cudaStream_t stream) {
    if (p.G < 1 || p.G > kMaxG) return (int)cudaErrorInvalidValue;
    Scratch x;
    long_scratch(BH, p.S, p.G, p.num_blocks, p.select_k,
                 static_cast<unsigned char*>(scratch), &x);
    int err = (int)cudaMemsetAsync(x.hist, 0, x.hist_bytes, stream);
    if (err != 0) return err;
    const size_t smem1 = score_layout(p.G, p.d).total;
    err = allow_smem(long_score_kernel<VEC>, smem1);
    if (err != 0) return err;
    long_score_kernel<VEC><<<dim3(x.nch, BH), kThreads, smem1, stream>>>(p,
                                                                          x);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const size_t smem2 = race_layout(p.G, p.d, p.dv, (int)sizeof(KV)).total;
    err = allow_smem(long_race_kernel<KV>, smem2);
    if (err != 0) return err;
    long_race_kernel<KV><<<dim3(kCluster, BH), kThreads, smem2, stream>>>(p,
                                                                          x);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    long_probs_kernel<<<dim3(x.nch, BH), kThreads, 0, stream>>>(p, x);
    return (int)cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// the sharded route's global race and its launches
// ---------------------------------------------------------------------------

// The global race of a sharded cache: one CTA a row takes the n·kc
// candidates the ranks gathered (cand [n][BH][kc] (key, global slot), the
// blocks in slot order, each block's candidates in select_topk's order, so
// that equal keys lie in global slot order), selects the K largest keys,
// ties to the lower position and so to the lower global slot, and writes
// the row's picks as slots of this rank's block (global - X.offset: a
// winner that another rank holds falls outside [0, S) and is not
// attended here). The winner set is the unsharded race's.
__host__ __device__ inline size_t merge_smem(int n, int kc) {
  return 4 * (256 + 4 + 2 * (size_t)kWarps) + 4 * (size_t)n * kc;
}

__global__ void __launch_bounds__(kThreads)
    shard_merge_kernel(const int2* __restrict__ cand, int n, int kc, int K,
                       int BH, const Scratch X) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* hist = reinterpret_cast<int*>(smem);
  int* sel = hist + 256;
  int* scan = sel + 4;
  uint32_t* keys = reinterpret_cast<uint32_t*>(scan + 2 * kWarps);
  const int row = blockIdx.x, tid = threadIdx.x, m = n * kc;
  for (int i = tid; i < m; i += kThreads) {
    const int b = i / kc;
    keys[i] = static_cast<uint32_t>(
        cand[((size_t)b * BH + row) * kc + (i - b * kc)].x);
  }
  __syncthreads();
  int* out = X.picks + (size_t)row * K;
  select_topk(CtaGroup{scan}, keys, 0, m, K, hist, sel, out, false);
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) {
    const int pos = out[i], b = pos / kc;
    out[i] = cand[((size_t)b * BH + row) * kc + (pos - b * kc)].y - X.offset;
  }
}

// One stage of the sharded route on one rank's block (S slots from global
// slot `offset`; Params.num_blocks is 1, select_k the launch's race size),
// over a scratch carved for `scratch_k` picks a row:
//   stage 0: zero the histograms, score, race kernel in `mode`;
//   stage 1: shard_merge_kernel over `cand` ([n][BH][kc] gathered);
//   stage 2: race kernel in `mode` (no score: picks written before);
//   stage 3: the probs kernel (X.mz holds the row's global (max, sum)).
// run() returns the CUDA error (0 on success); by_kind dispatches to it.
template <int VEC, typename KV>
struct LaunchShard {
  static int run(const Params& p, int BH, void* scratch, int scratch_k,
                 int stage, int mode, int offset, const void* cand, int n,
                 int kc, cudaStream_t stream) {
    if (p.G < 1 || p.G > kMaxG || p.num_blocks != 1)
      return (int)cudaErrorInvalidValue;
    Scratch x;
    long_scratch(BH, p.S, p.G, 1, scratch_k,
                 static_cast<unsigned char*>(scratch), &x, true);
    x.mode = mode;
    x.offset = offset;
    int err = 0;
    if (stage == 0) {
      err = (int)cudaMemsetAsync(x.hist, 0, x.hist_bytes, stream);
      if (err != 0) return err;
      const size_t smem1 = score_layout(p.G, p.d).total;
      err = allow_smem(long_score_kernel<VEC>, smem1);
      if (err != 0) return err;
      long_score_kernel<VEC><<<dim3(x.nch, BH), kThreads, smem1, stream>>>(
          p, x);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    if (stage == 0 || stage == 2) {
      const size_t smem2 = race_layout(p.G, p.d, p.dv, (int)sizeof(KV)).total;
      err = allow_smem(long_race_kernel<KV>, smem2);
      if (err != 0) return err;
      long_race_kernel<KV><<<dim3(kCluster, BH), kThreads, smem2, stream>>>(
          p, x);
    } else if (stage == 1) {
      const size_t smem = merge_smem(n, kc);
      if (kc < 1 || p.select_k > n * kc) return (int)cudaErrorInvalidValue;
      err = allow_smem(shard_merge_kernel, smem);
      if (err != 0) return err;
      shard_merge_kernel<<<BH, kThreads, smem, stream>>>(
          static_cast<const int2*>(cand), n, kc, p.select_k, BH, x);
    } else if (stage == 3) {
      long_probs_kernel<<<dim3(x.nch, BH), kThreads, 0, stream>>>(p, x);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
};

}  // namespace decode
