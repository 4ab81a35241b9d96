// Device code shared by the fused pruned-decode kernels for Hopper:
// ragged_decode.cu (global race; scores only the live slot blocks of each
// row; replaces the TPU kernel `ragged_decode`,
// src/repro/kernels/ragged_decode.py) and fused_decode.cu (a block-local
// race over all slots; replaces `fused_decode`,
// src/repro/kernels/fused_decode.py). Both run decode_row: one CTA of 256
// threads per row of [B*Hk], with the [G][S] f32 scores, the selection
// keys and the winners' K/V rows in shared memory, so only the inputs and
// (out, probs) touch device memory.
//
// Bound. A row must read its live mirror rows (live x d bytes) with their
// scale and valid bytes, its protection row, and the valid winners' K/V
// rows and scales, and write probs [S] and out [G][dv]. At the served
// shape (128 rows, S = 1088, d = 128, select_k = 128) that is about 25 MB a
// launch, 7.5 us at 3.35 TB/s: bytes bound it, and with 128 rows on 132
// SMs, the bytes one SM keeps in flight and the latency of each step of a
// row. What each stage does about that:
//   1. fetch_tile, score_tile: the live mirror rows stream through a ring
//      of kStages tiles of up to 256 slots in shared memory, each tile one
//      bulk copy (cp.async.bulk, the TMA) completing an mbarrier (4-byte
//      cp.async pieces where d % 16 != 0), so two 32 KB tiles are in flight
//      while one is scored (smaller tiles where a large S leaves less room);
//      the queries and the per-slot scales, valid and protection bytes
//      arrive by cp.async with the first tile. One thread
//      scores one slot, with 16-byte shared reads starting at a different
//      chunk in each thread (no bank conflicts) and dp4a, exact in int32:
//        score[g][s] = ((qq[g]·mirror[s]) * qscale[g]) * mscale[s]
//      rounded in the reference's order, NEG_INF at invalid slots. The same
//      thread writes the slot's selection key (the G-row sum in row order,
//      PROT_WIN at protected slots) as an order-preserving uint32 and counts
//      its top byte: the select's first histogram pass.
//   2. select_topk: a radix select over the keys. Four 8-bit histogram
//      passes in shared memory find the k-th key; every slot above it and
//      the lowest-index slots equal to it win. Its barrier count does not
//      grow with k. The winner set is lax.top_k's: a larger value wins, the
//      lower slot wins a tie, -0.0 equals +0.0 (as the TPU kernels' argmax
//      rounds treat them), protected slots always win, and invalid or dead
//      slots (all G·NEG_INF) fill the rest in slot order. ragged_decode
//      runs it across the CTA, fused_decode one warp per selection block
//      (the CTA when there is one block).
//   3. The valid winners are compacted; each K row is one bulk copy (and
//      each V row, once the probabilities are done), all in flight at once
//      (in chunks where they do not fit; cp.async pieces where a row is not
//      a multiple of 16 bytes).
//   4. charge_probs: probs[s] = Σ_g softmax_g(score/√d)[s], exactly 0
//      where the score is NEG_INF, while the K rows arrive.
//   5. Attention: logits by 8 lanes a winner (16-byte shared reads, kscale
//      applied per element) while the V rows arrive, one softmax a group
//      row, and p·v with every thread busy (the winners split over thread
//      parts whose sums are added in a fixed order).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kLanes = 8;            // lanes per winner (logits)
constexpr int kStages = 3;           // mirror ring depth
constexpr int kRingBytes = 96 * 1024;  // mirror ring, at most
constexpr size_t kSmemMax = 232448;  // what one block may opt into on Hopper
constexpr float kNegInf = -1e30f;
constexpr float kProtWin = 1e30f;

// What one launch reads and writes; pointers are at the start of the
// whole [BH, ...] tensors.
struct Params {
  const int* fills;  // ragged_decode only
  const float* q;
  const int8_t* qq;
  const float* qscale;
  const int8_t* mirror;
  const float* mscale;
  const float* kscale;
  const float* vscale;
  const int8_t* valid;
  const int8_t* prot;
  const void* k;
  const void* v;
  float* out;
  float* probs;
  int S, G, d, dv, select_k, num_blocks, block_s;
  float scale;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The widest copy (16, 8, 4 bytes; 1 = none) that tiles rows of `bytes`.
__host__ __device__ inline int granule(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 1;
}

// Byte offsets of one CTA's shared memory. The ring (scoring) and the
// winner stage (attention) are never live together and share `stage`; the
// mirror scales land in `key`, each read by the thread that then writes
// the slot's key. Only [G+1][S] words and two bytes a slot grow with S:
// the ring takes what room they leave, up to kRingBytes (tiles of at least
// one slot), and the winners are staged in chunks of what fits.
struct Layout {
  size_t score, key, ok, pr, qf, qq, qs, picks, win, wks, wvs, plog, part,
      hist, sel, scan, red, misc, bars, stage, total;
  int ts;        // slots per ring tile
  int cap;       // winner rows staged at once
  int k_stride;  // bytes between staged K rows (padded against bank conflicts)
  int v_stride;
};

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t here = at;
  at = align16(at + bytes);
  return here;
}

// Histograms the select needs: one a selection block, at most one a warp.
__host__ __device__ inline int histograms(int num_blocks) {
  return num_blocks < kWarps ? num_blocks : kWarps;
}

__host__ __device__ inline Layout layout(int S, int G, int d, int dv,
                                         int select_k, int elt,
                                         int num_blocks) {
  Layout m;
  size_t at = 0;
  m.score = take(at, 4 * (size_t)G * S);
  m.key = take(at, 4 * (size_t)S);
  m.ok = take(at, (size_t)S);
  m.pr = take(at, (size_t)S);
  m.qf = take(at, 4 * (size_t)G * d);
  m.qq = take(at, (size_t)G * d);
  m.qs = take(at, 4 * (size_t)kMaxG);
  m.picks = take(at, 4 * (size_t)select_k);
  m.win = take(at, 4 * (size_t)select_k);
  m.wks = take(at, 4 * (size_t)select_k);
  m.wvs = take(at, 4 * (size_t)select_k);
  m.plog = take(at, 4 * (size_t)G * select_k);
  m.part = take(at, 4 * (size_t)kThreads);
  m.hist = take(at, 4 * 256 * (size_t)histograms(num_blocks));
  m.sel = take(at, 4 * 2 * (size_t)kWarps);
  m.scan = take(at, 4 * 2 * (size_t)kWarps);
  m.red = take(at, 4 * (size_t)kWarps);
  m.misc = take(at, 16);
  m.bars = take(at, 8 * (size_t)(kStages + 2));  // ring stages, K, V
  m.stage = at;
  m.k_stride = (int)align16((size_t)d * elt) + 16;
  m.v_stride = (int)align16((size_t)dv * elt) + 16;
  const size_t pair = (size_t)m.k_stride + m.v_stride;
  const size_t room = kSmemMax > at ? kSmemMax - at : 0;
  const size_t fit = room / pair;
  m.cap = (int)(fit < (size_t)select_k ? (fit < 1 ? 1 : fit) : select_k);
  const size_t ts = (room < (size_t)kRingBytes ? room : kRingBytes) /
                    ((size_t)kStages * d);
  m.ts = ts < 1 ? 1 : ts > (size_t)kThreads ? kThreads : (int)ts;
  const size_t ring = (size_t)kStages * m.ts * d;
  const size_t winners = (size_t)m.cap * pair;
  m.total = at + (ring > winners ? ring : winners);
  return m;
}

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max (is_max) or sum over all threads' `v`; every thread gets
// the result. `red` holds kWarps floats.
__device__ __forceinline__ float block_reduce(float v, float* red,
                                              bool is_max) {
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // the previous reduction's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8, 16 B");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(N)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and 1-D bulk copies (the Tensor Memory Accelerator): one
// thread starts a copy of a contiguous run of 16-byte multiples, and its
// bytes complete the barrier's transaction count.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival of the barrier's phase, expecting `bytes` more.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// Order this thread's earlier shared-memory accesses before its later
// bulk copies (another proxy) into the same bytes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Start copying `bytes` from device to shared memory with every thread:
// cp.async in the widest pieces both addresses allow (16 or 4 bytes), the
// rest by plain loads. The caller commits, waits and synchronises.
__device__ inline void copy_to_smem(void* dst, const void* src, int bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src);
  const uint32_t to = smem_u32(dst);
  const char* from = static_cast<const char*>(src);
  int done = 0;
  if ((a & 15) == 0) {
    done = bytes & ~15;
    for (int x = threadIdx.x * 16; x < done; x += kThreads * 16)
      cp_async<16>(to + x, from + x);
  } else if ((a & 3) == 0) {
    done = bytes & ~3;
    for (int x = threadIdx.x * 4; x < done; x += kThreads * 4)
      cp_async<4>(to + x, from + x);
  }
  for (int x = done + threadIdx.x; x < bytes; x += kThreads)
    static_cast<char*>(dst)[x] = from[x];
}

// Order-preserving map of an f32 onto uint32 (a larger float, a larger
// key), with -0.0 made equal to +0.0.
__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// ---------------------------------------------------------------------------
// 1. the mirror stream and the scores
// ---------------------------------------------------------------------------

// Start the copy of ring tile t (slots [t*ts, min((t+1)*ts, live))) into
// ring stage t % kStages: one bulk copy on the stage's barrier when VEC ==
// 16 (d % 16 == 0, rows 16-byte aligned), else 4-byte cp.async pieces.
template <int VEC>
__device__ __forceinline__ void fetch_tile(unsigned char* ring,
                                           const int8_t* mir, int t, int ts,
                                           int live, int d, uint64_t* bars) {
  const int s0 = t * ts;
  if (s0 >= live) return;
  const int bytes = (min(s0 + ts, live) - s0) * d;
  const int8_t* src = mir + (size_t)s0 * d;
  unsigned char* dst = ring + (size_t)(t % kStages) * ts * d;
  if constexpr (VEC == 16) {
    if (threadIdx.x == 0) {
      uint64_t* bar = bars + t % kStages;
      fence_async_shared();
      mbar_expect(bar, bytes);
      bulk_copy(dst, src, bytes, bar);
    }
  } else {
    const uint32_t to = smem_u32(dst);
    for (int x = threadIdx.x * 4; x < bytes; x += kThreads * 4)
      cp_async<4>(to + x, src + x);
  }
}

// Score the n slots of one landed ring tile, one thread a slot (int32 dp4a
// sums in two chains, exact in any order), one group row after another.
// Writes score[g][s] and key[s], and with `hist1` counts the key's top byte
// in its selection block's histogram (256 ints a block of bs slots).
template <int VEC>
__device__ __forceinline__ void score_tile(
    const unsigned char* tile, int s0, int n, int S, int G, int d,
    const int* qq, const float* qs, const float* ms, const int8_t* ok,
    const int8_t* pr, float* score, uint32_t* key, int* hist1, int bs) {
  const int j = threadIdx.x;
  if (j >= n) return;
  const int s = s0 + j;
  const unsigned char* row = tile + (size_t)j * d;
  const bool valid = ok[s] != 0;
  const float m = ms[s];
  float sum = 0.f;
  for (int g = 0; g < G; ++g) {
    const int* qg = qq + g * (d >> 2);
    int a0 = 0, a1 = 0;
    if constexpr (VEC == 16) {
      // thread j starts at chunk j % units, so the 8 threads of a shared
      // memory phase read 8 different bank groups
      const int units = d >> 4;
      const int4* r = reinterpret_cast<const int4*>(row);
      const int4* q4 = reinterpret_cast<const int4*>(qg);
      int u = j % units;
#pragma unroll 4
      for (int c = 0; c < units; ++c) {
        const int4 x = r[u], w = q4[u];
        a0 = __dp4a(x.x, w.x, a0);
        a1 = __dp4a(x.y, w.y, a1);
        a0 = __dp4a(x.z, w.z, a0);
        a1 = __dp4a(x.w, w.w, a1);
        u = u + 1 == units ? 0 : u + 1;
      }
    } else {
      const int* r = reinterpret_cast<const int*>(row);
#pragma unroll 4
      for (int w = 0; w < (d >> 2); ++w) a0 = __dp4a(r[w], qg[w], a0);
    }
    const float sc =
        valid ? __fmul_rn(__fmul_rn((float)(a0 + a1), qs[g]), m) : kNegInf;
    score[g * S + s] = sc;
    sum = g == 0 ? sc : __fadd_rn(sum, sc);
  }
  const uint32_t x = order_key(pr[s] != 0 ? kProtWin : sum);
  key[s] = x;
  if (hist1 != nullptr) atomicAdd(&hist1[256 * (s / bs) + (x >> 24)], 1);
}

// ---------------------------------------------------------------------------
// 2. the radix select
// ---------------------------------------------------------------------------

// The whole CTA as one selecting group.
struct CtaGroup {
  int* scan;  // 2 * kWarps ints
  static constexpr int kSize = kThreads;
  __device__ int rank() const { return threadIdx.x; }
  __device__ void sync() const { __syncthreads(); }
  __device__ bool first_warp() const { return threadIdx.x < 32; }
  // exclusive prefix sums of a and b over the group, in rank order
  __device__ void scan2(int a, int b, int& ea, int& eb) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int ia = a, ib = b;
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(0xffffffffu, ia, o);
      const int yb = __shfl_up_sync(0xffffffffu, ib, o);
      if (lane >= o) {
        ia += ya;
        ib += yb;
      }
    }
    if (lane == 31) {
      scan[warp] = ia;
      scan[kWarps + warp] = ib;
    }
    __syncthreads();
    int pa = 0, pb = 0;
    for (int w = 0; w < warp; ++w) {
      pa += scan[w];
      pb += scan[kWarps + w];
    }
    ea = pa + ia - a;
    eb = pb + ib - b;
    __syncthreads();
  }
};

// One warp as a selecting group (fused_decode's selection blocks).
struct WarpGroup {
  static constexpr int kSize = 32;
  __device__ int rank() const { return threadIdx.x & 31; }
  __device__ void sync() const { __syncwarp(); }
  __device__ bool first_warp() const { return true; }
  __device__ void scan2(int a, int b, int& ea, int& eb) const {
    const int lane = threadIdx.x & 31;
    int ia = a, ib = b;
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(0xffffffffu, ia, o);
      const int yb = __shfl_up_sync(0xffffffffu, ib, o);
      if (lane >= o) {
        ia += ya;
        ib += yb;
      }
    }
    ea = ia - a;
    eb = ib - b;
  }
};

// One warp finds the histogram bin that holds the rem-th largest key:
// sel[0] = the bin, sel[1] = how many keys of that bin still win.
__device__ __forceinline__ void find_bin(const int* hist, int rem, int* sel) {
  const int lane = threadIdx.x & 31;
  int c[8], sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[i] = hist[255 - 8 * lane - i];  // lane 0 holds the top bins
    sum += c[i];
  }
  int inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  int above = inc - sum;
  if (above < rem && rem <= inc) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (above + c[i] >= rem) {
        sel[0] = 255 - 8 * lane - i;
        sel[1] = rem - above;
        break;
      }
      above += c[i];
    }
  }
}

// The k largest keys of key[lo, hi) (k <= hi - lo), ties to the lower
// slot, into out[0, k): first the slots above the k-th key in slot order,
// then the lowest-index slots equal to it. Four 8-bit histogram passes;
// `hist` holds 256 ints and `sel` 2 for this group. With `counted`, hist
// already holds the first pass's counts (the top bytes).
template <class Group>
__device__ void select_topk(const Group& grp, const uint32_t* key, int lo,
                            int hi, int k, int* hist, int* sel, int* out,
                            bool counted) {
  uint32_t prefix = 0u, mask = 0u;
  int rem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (!counted || shift != 24) {
      for (int i = grp.rank(); i < 256; i += Group::kSize) hist[i] = 0;
      grp.sync();
      for (int s = lo + grp.rank(); s < hi; s += Group::kSize) {
        const uint32_t x = key[s];
        if ((x & mask) == prefix) atomicAdd(&hist[(x >> shift) & 255u], 1);
      }
      grp.sync();
    }
    if (grp.first_warp()) find_bin(hist, rem, sel);
    grp.sync();
    prefix |= static_cast<uint32_t>(sel[0]) << shift;
    mask |= 255u << shift;
    rem = sel[1];
  }
  // prefix is the k-th key; rem slots equal to it win
  const int per = (hi - lo + Group::kSize - 1) / Group::kSize;
  const int a = lo + grp.rank() * per, b = min(a + per, hi);
  int gt = 0, eq = 0;
  for (int s = a; s < b; ++s) {
    const uint32_t x = key[s];
    gt += x > prefix;
    eq += x == prefix;
  }
  int at_gt, at_eq;
  grp.scan2(gt, eq, at_gt, at_eq);
  const int n_gt = k - rem;
  for (int s = a; s < b; ++s) {
    const uint32_t x = key[s];
    if (x > prefix) {
      out[at_gt++] = s;
    } else if (x == prefix) {
      if (at_eq < rem) out[n_gt + at_eq] = s;
      ++at_eq;
    }
  }
}

// ---------------------------------------------------------------------------
// 3-5. winners, probabilities, attention
// ---------------------------------------------------------------------------

// Start copying rows idx[0, n) of `base` (rows of `len` elements) into
// shared memory at `dst`, `stride` bytes apart: one bulk copy a row on
// `bar` when the rows' bytes are a multiple of 16 (the caller then waits on
// it), else cp.async pieces (rows whose bytes are not a multiple of 4 by
// plain loads).
template <typename KV>
__device__ inline void fetch_rows(unsigned char* dst, int stride,
                                  const KV* base, int len, const int* idx,
                                  int n, uint64_t* bar) {
  const int rb = len * (int)sizeof(KV);
  const int gr = granule(rb);
  const char* src = reinterpret_cast<const char*>(base);
  if (gr == 16) {
    fence_async_shared();
    if (threadIdx.x == 0) mbar_expect(bar, (uint32_t)(n * rb));
    for (int r = threadIdx.x; r < n; r += kThreads)
      bulk_copy(dst + (size_t)r * stride, src + (size_t)idx[r] * rb, rb, bar);
    return;
  }
  const int per = gr > 1 ? rb / gr : rb;
  for (int x = threadIdx.x; x < n * per; x += kThreads) {
    const int r = x / per, o = (x - r * per) * gr;
    const char* from = src + (size_t)idx[r] * rb + o;
    unsigned char* to = dst + (size_t)r * stride + o;
    switch (gr) {
      case 8:
        cp_async<8>(smem_u32(to), from);
        break;
      case 4:
        cp_async<4>(smem_u32(to), from);
        break;
      default:
        *to = *reinterpret_cast<const unsigned char*>(from);
    }
  }
}

// Elements of a 16-byte chunk of K/V as floats.
template <typename KV>
struct Chunk {
  static constexpr int kN = 16 / (int)sizeof(KV);
  __device__ __forceinline__ static void load(const KV* p, float* f) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < kN; ++i) f[i] = to_f32(e[i]);
  }
};

// logit[g][c0 + j] = (q[g] · (K row j * kscale)) * scale for the n staged
// winner rows; 8 lanes a winner (16-byte shared reads where the rows
// allow), one group row after another.
template <typename KV>
__device__ __forceinline__ void winner_logits(const unsigned char* kst,
                                              int stride, const float* qf,
                                              const float* wks, float* plog,
                                              int plog_stride, int c0, int n,
                                              int G, int d, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane & (kLanes - 1), grp = lane / kLanes;
  constexpr int kPerWarp = 32 / kLanes, kN = Chunk<KV>::kN;
  const bool wide = (d * (int)sizeof(KV)) % 16 == 0;
  for (int j0 = warp * kPerWarp; j0 < n; j0 += kWarps * kPerWarp) {
    const int j = j0 + grp;
    const bool live = j < n;
    const KV* kr = reinterpret_cast<const KV*>(kst + (size_t)j * stride);
    const float ks = live ? wks[c0 + j] : 0.f;
    for (int g = 0; g < G; ++g) {
      const float* qg = qf + g * d;
      float acc = 0.f;
      if (live && wide) {
        for (int c = sub * kN; c < d; c += kLanes * kN) {
          float kv[kN];
          Chunk<KV>::load(kr + c, kv);
          const float4* q4 = reinterpret_cast<const float4*>(qg + c);
#pragma unroll
          for (int i = 0; i < kN / 4; ++i) {
            const float4 qv = q4[i];
            acc += qv.x * __fmul_rn(kv[4 * i], ks);
            acc += qv.y * __fmul_rn(kv[4 * i + 1], ks);
            acc += qv.z * __fmul_rn(kv[4 * i + 2], ks);
            acc += qv.w * __fmul_rn(kv[4 * i + 3], ks);
          }
        }
      } else if (live) {
        for (int c = sub; c < d; c += kLanes)
          acc += qg[c] * __fmul_rn(to_f32(kr[c]), ks);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (live && sub == 0)
        plog[g * plog_stride + c0 + j] = __fmul_rn(acc, scale);
    }
  }
}

// Σ_{j in [lo, hi)} p[j] * (V row j [c] * vscale[j]) over staged V rows,
// in four interleaved partial sums added in a fixed order.
template <typename KV>
__device__ __forceinline__ float value_sum(const unsigned char* vst,
                                           int stride, const float* vs,
                                           const float* p, int lo, int hi,
                                           int c) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  int j = lo;
  for (; j + 4 <= hi; j += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const KV* vr =
          reinterpret_cast<const KV*>(vst + (size_t)(j + i) * stride);
      a[i] += p[j + i] * __fmul_rn(to_f32(vr[c]), vs[j + i]);
    }
  }
  for (; j < hi; ++j) {
    const KV* vr = reinterpret_cast<const KV*>(vst + (size_t)j * stride);
    a[0] += p[j] * __fmul_rn(to_f32(vr[c]), vs[j]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// out[g][c] (+)= Σ_j p[g][c0 + j] * (V row j [c] * vscale) over the n
// staged winner rows. With G·dv at most half the threads, the winners are
// split into parts of consecutive rows whose sums are added in part order.
template <typename KV>
__device__ inline void winner_values(const unsigned char* vst, int stride,
                                     const float* wvs, const float* plog,
                                     int plog_stride, float* part,
                                     float* out_row, int c0, int n, int G,
                                     int dv, bool first) {
  const int tid = threadIdx.x, nout = G * dv;
  const int parts = 2 * nout <= kThreads ? kThreads / nout : 1;
  if (parts > 1) {
    const int h = tid / nout, x = tid - h * nout;
    if (h < parts) {
      const int g = x / dv, c = x - g * dv;
      const float* pl = plog + g * plog_stride + c0;
      const int lo = h * n / parts, hi = (h + 1) * n / parts;
      part[tid] = value_sum<KV>(vst, stride, wvs + c0, pl, lo, hi, c);
    }
    __syncthreads();
    if (tid < nout) {
      float r = first ? 0.f : out_row[tid];
      for (int p = 0; p < parts; ++p) r += part[p * nout + tid];
      out_row[tid] = r;
    }
    __syncthreads();  // part is free again
  } else {
    for (int x = tid; x < nout; x += kThreads) {
      const int g = x / dv, c = x - g * dv;
      const float* pl = plog + g * plog_stride + c0;
      out_row[x] = (first ? 0.f : out_row[x]) +
                   value_sum<KV>(vst, stride, wvs + c0, pl, 0, n, c);
    }
  }
}

// The charge-domain probabilities from the score buffer:
//   probs[s] = sum_g softmax_g(score[g][:] / sqrt(d))[s],
// exactly 0 where score is NEG_INF (invalid or unscored slots). Each row of
// `score` is overwritten by its exponentials; `acc` is S floats of scratch
// (each thread uses only its own slots).
__device__ inline void charge_probs(float* score, float* red, float* acc,
                                    float* probs_row, int S, int G,
                                    float scale) {
  const int tid = threadIdx.x;
  for (int g = 0; g < G; ++g) {
    float* sc = score + g * S;
    float mx = -INFINITY;
    for (int s = tid; s < S; s += kThreads)
      mx = fmaxf(mx, __fmul_rn(sc[s], scale));
    mx = block_reduce(mx, red, true);
    float z = 0.f;
    for (int s = tid; s < S; s += kThreads) {
      const float x = sc[s];
      const float ex = x > 0.5f * kNegInf ? expf(__fmul_rn(x, scale) - mx)
                                          : 0.f;
      sc[s] = ex;
      z += ex;
    }
    z = fmaxf(block_reduce(z, red, false), 1e-30f);
    for (int s = tid; s < S; s += kThreads) {
      const float p = (g == 0 ? 0.f : acc[s]) + sc[s] / z;
      if (g + 1 == G)
        probs_row[s] = p;
      else
        acc[s] = p;
    }
  }
}

// ---------------------------------------------------------------------------
// the row
// ---------------------------------------------------------------------------

// Decode row `row`: score slots [0, live) (slots past it are dead: NEG_INF
// scores, selection value G·NEG_INF or PROT_WIN), race the num_blocks
// selection blocks for select_k / num_blocks winners each, attend exactly
// over the valid winners, and write out and probs. VEC is the mirror
// copy's width (16 when d % 16 == 0, else 4).
template <int VEC, typename KV>
__device__ __forceinline__ void decode_row(const Params& P,
                                           unsigned char* smem, int row,
                                           int live) {
  const int S = P.S, G = P.G, d = P.d, dv = P.dv, K = P.select_k;
  const Layout L = layout(S, G, d, dv, K, (int)sizeof(KV), P.num_blocks);
  float* score = reinterpret_cast<float*>(smem + L.score);
  uint32_t* key = reinterpret_cast<uint32_t*>(smem + L.key);
  float* ms = reinterpret_cast<float*>(smem + L.key);  // until keyed
  int8_t* ok = reinterpret_cast<int8_t*>(smem + L.ok);
  int8_t* pr = reinterpret_cast<int8_t*>(smem + L.pr);
  float* qf = reinterpret_cast<float*>(smem + L.qf);
  int* qq = reinterpret_cast<int*>(smem + L.qq);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  int* picks = reinterpret_cast<int*>(smem + L.picks);
  int* win = reinterpret_cast<int*>(smem + L.win);
  float* wks = reinterpret_cast<float*>(smem + L.wks);
  float* wvs = reinterpret_cast<float*>(smem + L.wvs);
  float* plog = reinterpret_cast<float*>(smem + L.plog);
  float* part = reinterpret_cast<float*>(smem + L.part);
  int* hist = reinterpret_cast<int*>(smem + L.hist);
  int* sel = reinterpret_cast<int*>(smem + L.sel);
  int* scan = reinterpret_cast<int*>(smem + L.scan);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  unsigned char* stage = smem + L.stage;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rs = (size_t)row * S;
  const int8_t* mir = P.mirror + rs * d;
  const int8_t* prot_row = P.prot + rs;
  const KV* k_row = static_cast<const KV*>(P.k) + rs * d;
  const KV* v_row = static_cast<const KV*>(P.v) + rs * dv;
  float* out_row = P.out + (size_t)row * G * dv;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* bar_k = bars + kStages;
  uint64_t* bar_v = bars + kStages + 1;
  // -- 1. the mirror stream: the first kStages - 1 tiles start first (by
  //       the thread that sets up the barriers, when they are bulk
  //       copies), then the queries and per-slot inputs (in tile 0's group)
  const int ts = L.ts;
  const int ntiles = (live + ts - 1) / ts;
  if (tid == 0) {
    for (int i = 0; i < kStages + 2; ++i) mbar_init(bars + i);
    mbar_init_fence();
  }
  if constexpr (VEC == 16)
    for (int t = 0; t < kStages - 1; ++t)
      fetch_tile<VEC>(stage, mir, t, ts, live, d, bars);
  __syncthreads();
  copy_to_smem(qf, P.q + (size_t)row * G * d, 4 * G * d);
  copy_to_smem(qq, P.qq + (size_t)row * G * d, G * d);
  copy_to_smem(ms, P.mscale + rs, 4 * live);
  copy_to_smem(ok, P.valid + rs, live);
  copy_to_smem(pr, prot_row, S);
  copy_to_smem(qs, P.qscale + (size_t)row * G, 4 * G);
  for (int t = 0; t < kStages - 1; ++t) {
    if constexpr (VEC != 16) fetch_tile<VEC>(stage, mir, t, ts, live, d, bars);
    cp_async_commit();
  }
  // the select's first pass is counted while scoring when every selection
  // block has a histogram of its own
  const int nb = P.num_blocks, bs = S / nb;
  int* hist1 = nb <= kWarps ? hist : nullptr;
  for (int i = tid; i < 256 * histograms(nb); i += kThreads) hist[i] = 0;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's pieces of tile t landed
    if constexpr (VEC == 16) mbar_wait(bars + t % kStages, (t / kStages) & 1);
    __syncthreads();               // everyone's; and tile t - 1 is scored
    fetch_tile<VEC>(stage, mir, t + kStages - 1, ts, live, d, bars);
    cp_async_commit();
    score_tile<VEC>(stage + (size_t)(t % kStages) * ts * d, t * ts,
                    min(ts, live - t * ts), S, G, d, qq, qs, ms, ok, pr, score,
                    key, hist1, bs);
  }
  cp_async_wait<0>();
  __syncthreads();
  float dead = kNegInf;  // the G-row sum of a slot that is not scored
  for (int g = 1; g < G; ++g) dead = __fadd_rn(dead, kNegInf);
  for (int s = live + tid; s < S; s += kThreads) {
    for (int g = 0; g < G; ++g) score[g * S + s] = kNegInf;
    const uint32_t x = order_key(pr[s] != 0 ? kProtWin : dead);
    key[s] = x;
    if (hist1 != nullptr) atomicAdd(&hist1[256 * (s / bs) + (x >> 24)], 1);
  }
  __syncthreads();

  // -- 2. the race --------------------------------------------------------
  if (nb == 1) {
    select_topk(CtaGroup{scan}, key, 0, S, K, hist, sel, picks, true);
  } else {
    const int k_loc = K / nb;
    for (int b = warp; b < nb; b += kWarps)
      select_topk(WarpGroup{}, key, b * bs, (b + 1) * bs, k_loc,
                  hist + 256 * warp, sel + 2 * warp, picks + b * k_loc,
                  hist1 != nullptr);
  }
  __syncthreads();

  // -- 3. the valid winners, in pick order; their rows start to fly -------
  if (warp == 0) {
    int n = 0;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      const int p = j < K ? picks[j] : 0;
      const bool v = j < K && score[p] > 0.5f * kNegInf;
      const unsigned vote = __ballot_sync(0xffffffffu, v);
      if (v) win[n + __popc(vote & ((1u << lane) - 1u))] = p;
      n += __popc(vote);
    }
    if (lane == 0) misc[0] = n;
  }
  __syncthreads();
  const int nv = misc[0];
  const int cap = L.cap;
  const int nch = nv > 0 ? (nv + cap - 1) / cap : 1;
  unsigned char* kst = stage;
  unsigned char* vst = stage + (size_t)cap * L.k_stride;
  const bool bulk_k = granule(d * (int)sizeof(KV)) == 16;
  const bool bulk_v = granule(dv * (int)sizeof(KV)) == 16;
  fetch_rows<KV>(kst, L.k_stride, k_row, d, win, min(nv, cap), bar_k);
  for (int j = tid; j < nv; j += kThreads) {
    cp_async<4>(smem_u32(wks + j), P.kscale + rs + win[j]);
    cp_async<4>(smem_u32(wvs + j), P.vscale + rs + win[j]);
  }
  cp_async_commit();

  // -- 4. charge-domain probabilities, while the winners' K rows arrive ---
  charge_probs(score, red, reinterpret_cast<float*>(key), P.probs + rs, S,
               G, P.scale);  // the keys are spent
  fetch_rows<KV>(vst, L.v_stride, v_row, dv, win, min(nv, cap), bar_v);
  cp_async_commit();  // the V rows arrive during the logits and softmax
  cp_async_wait<1>();
  if (bulk_k) mbar_wait(bar_k, 0);
  __syncthreads();

  // -- 5. exact attention over the valid winners ---------------------------
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * cap, n = min(cap, nv - c0);
    if (c > 0) {
      __syncthreads();  // the previous chunk's K rows are read
      fetch_rows<KV>(kst, L.k_stride, k_row, d, win + c0, n, bar_k);
      cp_async_commit();
      cp_async_wait<0>();
      if (bulk_k) mbar_wait(bar_k, c & 1);
      __syncthreads();
    }
    winner_logits<KV>(kst, L.k_stride, qf, wks, plog, K, c0, n, G, d,
                      P.scale);
  }
  __syncthreads();
  cp_async_wait<0>();  // the V rows (read after the softmax's barriers)
  if (bulk_v) mbar_wait(bar_v, 0);
  for (int g = 0; g < G; ++g) {  // one softmax a group row
    float* pl = plog + g * K;
    float mx = -INFINITY;
    for (int j = tid; j < nv; j += kThreads) mx = fmaxf(mx, pl[j]);
    mx = block_reduce(mx, red, true);
    float z = 0.f;
    for (int j = tid; j < nv; j += kThreads) {
      const float e = expf(pl[j] - mx);
      pl[j] = e;
      z += e;
    }
    z = fmaxf(block_reduce(z, red, false), 1e-30f);
    for (int j = tid; j < nv; j += kThreads) pl[j] = pl[j] / z;
  }
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * cap, n = max(0, min(cap, nv - c0));
    if (c > 0) {
      __syncthreads();  // the previous chunk's V rows are read
      fetch_rows<KV>(vst, L.v_stride, v_row, dv, win + c0, n, bar_v);
      cp_async_commit();
      cp_async_wait<0>();
      if (bulk_v) mbar_wait(bar_v, c & 1);
      __syncthreads();
    }
    winner_values<KV>(vst, L.v_stride, wvs, plog, K, part, out_row, c0, n,
                      G, dv, c == 0);
  }
}

// Dispatch on the mirror copy width (d % 16 == 0: 16 bytes, else 4) and
// the K/V element type (0 = f32, 1 = bf16, 2 = int8).
template <template <int, typename> class Launch, typename... Args>
int by_kind(int d, int kv_kind, Args... args) {
  const bool wide = d % 16 == 0;
  switch (kv_kind) {
    case 0:
      return wide ? Launch<16, float>::run(args...)
                  : Launch<4, float>::run(args...);
    case 1:
      return wide ? Launch<16, __nv_bfloat16>::run(args...)
                  : Launch<4, __nv_bfloat16>::run(args...);
    case 2:
      return wide ? Launch<16, int8_t>::run(args...)
                  : Launch<4, int8_t>::run(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Bytes of K/V element `kv_kind`.
inline int kv_bytes(int kv_kind) {
  return kv_kind == 0 ? 4 : kv_kind == 1 ? 2 : 1;
}

// Dispatch on the K/V element type alone (gather_attention.cu).
template <template <typename> class Launch, typename... Args>
int by_kv_kind(int kv_kind, Args... args) {
  switch (kv_kind) {
    case 0:
      return Launch<float>::run(args...);
    case 1:
      return Launch<__nv_bfloat16>::run(args...);
    case 2:
      return Launch<int8_t>::run(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Set the kernel's dynamic shared memory above the 48 KB default when it
// needs it; returns the CUDA error (0 on success).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch `kernel` with one CTA per row and the shared memory `smem`;
// returns the CUDA error.
template <typename Kernel>
int launch(Kernel kernel, const Params& p, int BH, size_t smem,
           cudaStream_t stream) {
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<BH, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace decode
