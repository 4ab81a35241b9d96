// Device code shared by the fused pruned-decode kernels for Hopper
// (ragged_decode.cu: global race over the live slots of each row;
// fused_decode.cu: block-local race over all slots). Both run one CTA of
// kThreads threads per row of [B*Hk] and keep the [G][S] f32 score buffer
// in shared memory; they differ only in which slots they score and in the
// race. The stages here are the ones they share:
//   score_slots     CAM scoring, one warp per slot (dp4a, exact in int32)
//   selection_sums  the G-row sum in row order, protected slots PROT_WIN
//   attend_winners  exact softmax attention over the picked slots
//   charge_probs    probs[s] = sum_g softmax_g(score/sqrt(d))
// Each stage ends with every thread past a __syncthreads() where its
// results are read by other threads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <math.h>

namespace decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;
constexpr float kProtWin = 1e30f;
// below the group sum G*kNegInf of an invalid slot, so the race picks
// distinct slots exactly as lax.top_k does
constexpr float kPicked = -1e35f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// Race order: a larger value wins, the lower slot wins a tie, and an empty
// candidate (INT_MAX) always loses, so a pick is always a real slot.
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  if (bi == INT_MAX) return true;
  if (i == INT_MAX) return false;
  return v > bv || (v == bv && i < bi);
}

// The (value, slot) winner among the 32 lanes' candidates, in every lane.
__device__ __forceinline__ void warp_argmax(float& cv, int& ci) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, cv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, ci, o);
    if (beats(ov, oi, cv, ci)) {
      cv = ov;
      ci = oi;
    }
  }
}

// Shared-memory layout of one CTA, as offsets into the dynamic buffer.
struct Smem {
  float* score;  // [G][S]
  float* ssel;   // [S]
  float* qf;     // [G][d]
  float* plog;   // [G][select_k]
  float* red;    // [kWarps]
  float* red_v;  // [kWarps]
  int* red_i;    // [kWarps]
  int* picks;    // [select_k]
  int* qq4;      // [G][d/4]
};

__host__ __device__ inline size_t smem_bytes(int S, int G, int d,
                                             int select_k) {
  return sizeof(float) * ((size_t)G * S + S + (size_t)G * d +
                          (size_t)G * select_k + 2 * kWarps) +
         sizeof(int) * (kWarps + (size_t)select_k) + (size_t)G * d;
}

__device__ inline Smem carve(unsigned char* raw, int S, int G, int d,
                             int select_k) {
  Smem m;
  m.score = reinterpret_cast<float*>(raw);
  m.ssel = m.score + G * S;
  m.qf = m.ssel + S;
  m.plog = m.qf + G * d;
  m.red = m.plog + G * select_k;
  m.red_v = m.red + kWarps;
  m.red_i = reinterpret_cast<int*>(m.red_v + kWarps);
  m.picks = m.red_i + kWarps;
  m.qq4 = m.picks + select_k;
  return m;
}

// Stage the row's queries (f32 and int8 words); score[g][s] = NEG_INF for
// s >= live (slots that are not scored). Ends with a barrier.
__device__ inline void stage_queries(const Smem& m, const float* q_row,
                                     const int8_t* qq_row, int S, int G,
                                     int d, int live) {
  const int tid = threadIdx.x, d4 = d >> 2;
  for (int x = tid; x < G * d; x += kThreads) m.qf[x] = q_row[x];
  const int* qq_w = reinterpret_cast<const int*>(qq_row);
  for (int x = tid; x < G * d4; x += kThreads) m.qq4[x] = qq_w[x];
  for (int x = tid; x < G * S; x += kThreads)
    if (x % S >= live) m.score[x] = kNegInf;
  __syncthreads();
}

// CAM scoring of slots [0, live): one warp per slot,
//   score[g][s] = ((qq[g]·mirror[s]) * qscale[g]) * mscale[s]
// with the integer dot in dp4a (exact) and the two products rounded in the
// reference's order; NEG_INF at invalid slots. Ends with a barrier.
__device__ inline void score_slots(const Smem& m, const int8_t* mir_row,
                                   const float* ms_row, const float* qs_row,
                                   const int8_t* valid_row, int S, int G,
                                   int d, int live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d4 = d >> 2;
  for (int s = warp; s < live; s += kWarps) {
    int acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0;
    const int* m4 = reinterpret_cast<const int*>(mir_row + (size_t)s * d);
    for (int w = lane; w < d4; w += 32) {
      const int mw = m4[w];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = __dp4a(mw, m.qq4[g * d4 + w], acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] = warp_sum_i(acc[g]);
    if (lane == 0) {
      const bool ok = valid_row[s] != 0;
      const float ms = ms_row[s];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G)
          m.score[g * S + s] =
              ok ? __fmul_rn(__fmul_rn((float)acc[g], qs_row[g]), ms)
                 : kNegInf;
    }
  }
  __syncthreads();
}

// ssel[s] = sum_g score[g][s] in row order; protected slots PROT_WIN.
// Ends with a barrier.
__device__ inline void selection_sums(const Smem& m, const int8_t* prot_row,
                                      int S, int G) {
  for (int s = threadIdx.x; s < S; s += kThreads) {
    float t = m.score[s];
    for (int g = 1; g < G; ++g) t = __fadd_rn(t, m.score[g * S + s]);
    m.ssel[s] = prot_row[s] != 0 ? kProtWin : t;
  }
  __syncthreads();
}

// Exact softmax attention over the n_pick slots in picks[]: only the
// winners' K/V rows are read, times kscale / vscale; invalid winners are
// masked, and a row whose winners are all invalid gives out = 0.
// One warp per winner for the logits, one softmax over all winners per
// group row, then one thread per output element. Ends with a barrier.
template <typename KV>
__device__ inline void attend_winners(const Smem& m, const KV* k_row,
                                      const KV* v_row, const float* ks_row,
                                      const float* vs_row,
                                      const int8_t* valid_row, float* out_row,
                                      int G, int d, int dv, int n_pick,
                                      float scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = warp; j < n_pick; j += kWarps) {
    const int p = m.picks[j];
    if (valid_row[p] == 0) {
      if (lane == 0)
        for (int g = 0; g < G; ++g) m.plog[g * n_pick + j] = kNegInf;
      continue;
    }
    const float ks = ks_row[p];
    const KV* kr = k_row + (size_t)p * d;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float kv = __fmul_rn(to_f32(kr[c]), ks);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] += m.qf[g * d + c] * kv;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] = warp_sum(acc[g]);
    if (lane == 0)
      for (int g = 0; g < G; ++g)
        m.plog[g * n_pick + j] = __fmul_rn(acc[g], scale);
  }
  __syncthreads();

  // masked softmax over the winners, one group row at a time
  for (int g = 0; g < G; ++g) {
    float* pl = m.plog + g * n_pick;
    float mx = -INFINITY;
    for (int j = tid; j < n_pick; j += kThreads) mx = fmaxf(mx, pl[j]);
    mx = block_reduce(mx, m.red, true);
    float z = 0.f;
    for (int j = tid; j < n_pick; j += kThreads) {
      const float l = pl[j];
      const float e = l > 0.5f * kNegInf ? expf(l - mx) : 0.f;
      pl[j] = e;
      z += e;
    }
    z = fmaxf(block_reduce(z, m.red, false), 1e-30f);
    for (int j = tid; j < n_pick; j += kThreads) pl[j] = pl[j] / z;
  }
  __syncthreads();

  for (int x = tid; x < G * dv; x += kThreads) {
    const int g = x / dv, c = x - g * dv;
    const float* pl = m.plog + g * n_pick;
    float acc = 0.f;
    for (int j = 0; j < n_pick; ++j) {
      const float p = pl[j];
      if (p != 0.f) {
        const int s = m.picks[j];
        acc += p * __fmul_rn(to_f32(v_row[(size_t)s * dv + c]), vs_row[s]);
      }
    }
    out_row[x] = acc;
  }
}

// The charge-domain probabilities from the score buffer:
//   probs[s] = sum_g softmax_g(score[g][:] / sqrt(d))[s],
// exactly 0 where score is NEG_INF (invalid or unscored slots).
__device__ inline void charge_probs(const Smem& m, float* probs_row, int S,
                                    int G, float scale) {
  const int tid = threadIdx.x;
  float mg[kMaxG], zg[kMaxG];
  for (int g = 0; g < G; ++g) {
    const float* sc = m.score + g * S;
    float mx = -INFINITY;
    for (int s = tid; s < S; s += kThreads)
      mx = fmaxf(mx, __fmul_rn(sc[s], scale));
    mx = block_reduce(mx, m.red, true);
    float z = 0.f;
    for (int s = tid; s < S; s += kThreads) {
      const float x = sc[s];
      if (x > 0.5f * kNegInf) z += expf(__fmul_rn(x, scale) - mx);
    }
    mg[g] = mx;
    zg[g] = fmaxf(block_reduce(z, m.red, false), 1e-30f);
  }
  for (int s = tid; s < S; s += kThreads) {
    float p = 0.f;
    for (int g = 0; g < G; ++g) {
      const float x = m.score[g * S + s];
      if (x > 0.5f * kNegInf) p += expf(__fmul_rn(x, scale) - mg[g]) / zg[g];
    }
    probs_row[s] = p;
  }
}

// Dispatch on the K/V element type: 0 = f32, 1 = bf16, 2 = int8.
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

}  // namespace decode
