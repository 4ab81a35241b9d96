// The backward of causal prompt attention, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference trains through plain XLA autodiff:
// `jax.value_and_grad` (src/repro/launch/train.py:95) differentiates
// `chunked_causal_attention` (src/repro/core/attention.py:490), a scan of
// XLA dot_generals. The port's causal attention on the card is the
// hand-written `flash_prefill` kernel (csrc/flash_prefill.cu), which has no
// gradient, so training needs this one: the gradient of the function that
// `chunked_causal_attention` computes for `out` (its column sums get no
// cotangent: training discards them).
//
//   q    [B, Hq, N, d]  T       k, v [B, Hk, N, d]  T (T = f32 or bf16)
//   dout [B, Hq, N, d]  f32, or bf16 where T is bf16: the cotangent of out
//   → dq [B, Hq, N, d]  T, dk and dv [B, Hk, N, d] T, each summed over the
//     g = Hq / Hk q-heads of its group; stats [3, B*Hq, N] f32 scratch (m,
//     l and D; the bf16 route keeps m in base-2 units and 1 / max(l,
//     1e-30) in place of l).
//
// Per row i of one q-head, with s_ij = (q_i . k_j) * scale on the columns
// j <= i (NEG_INF = -1e30 elsewhere), m_i = max_j s_ij, l_i = sum_j
// exp(s_ij - m_i) and P_ij = exp(s_ij - m_i) / max(l_i, 1e-30):
//   dP_ij = T(dout_i . v_j)             rounded to T, as the reference's
//                                       cotangent of a bf16 operand is
//   D_i   = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - D_i) * scale
//   dq_i  = T(sum_j dS_ij k_j)
//   dk_j  = T(sum over the group's heads and rows i >= j of dS_ij q_i)
//   dv_j  = T(sum over the group's heads and rows of T(P_ij) dout_i)
// (T(P) is the forward's rounded probability, the operand of p.v.) The
// plain version is `kernels/ref.flash_prefill_bwd_ref`; with f32 inputs
// every T() is the identity.
//
// Two routes, chosen by T (neither falls back to the other), as in
// flash_prefill.cu; both make the same two kernels on one stream:
//   dq kernel     one CTA per (q-head, 64-row q-block), the late q-blocks
//                 (the most key tiles) first, over the key tiles at or
//                 before its last row. Sweep 1 carries m, l and sum_j
//                 exp(s_ij - m) dP_ij (bf16 route: dP_ij - dP_i0) online
//                 (the rescaling of the forward's online softmax) and
//                 gives D_i; it writes m, l and D to the stats. Sweep 2
//                 recomputes s and dP, makes dS and adds dS k into dq in
//                 registers.
//   dk/dv kernel  one CTA per (kv-head, 64-key block), after it: K and V
//                 stay in shared memory while the CTA walks the group's
//                 q-heads and, for each, the q rows at or after its key
//                 block; it recomputes s and dP, takes P and dS from the
//                 stats, and adds T(P)^T dout into dv and dS^T q into dk in
//                 registers, in head order, then row order.
// Each output element is summed by one thread in a fixed order, with no
// atomics, so two launches on the same inputs give the same bits.
//
// The bf16 route (bwd_dq_tc_kernel, bwd_dkv_tc_kernel): every product is a
// warpgroup product on the tensor cores (wgmma, bf16 operands, f32
// accumulators; hopper_mma.cuh), one warpgroup (128 threads) a CTA. Tiles
// are bf16 in shared memory as 64-column blocks of 128-byte swizzled rows,
// d padded with zeros to a multiple of 64: d = 112 fills two blocks, the
// products over d take d / 16 k-steps and never read the padding, and the
// products whose width is d run as one m64n64 product a block (the padded
// columns of their results are dropped). Tiles arrive by cp.async (16-byte
// copies, zeros past N), in rings: two K/V tiles in flight in the dq
// kernel, three 32-row q/dout tiles (with their rows' m, l and D, 4-byte
// copies) in the dk/dv kernel. (Not TMA: a tensor map is encoded by the
// driver API, which this library, bound by ctypes without libcuda, does
// not call, and an f32 dout is split as it is staged.)
//   dq kernel     S = Q K^T and dP = dout V^T as m64n64 products, Q, dout
//                 and the key tile K-major from shared memory; dq += dS K
//                 as m64n64 products with A = dS's bf16 hi, then lo, half
//                 from registers (an accumulator's layout is the A
//                 fragment's) and B the K tile MN-major. Q and dout stay
//                 in shared memory.
//   dk/dv kernel  S^T = K Q^T and dP^T = V dout^T as m64n32 products (the
//                 64 keys are the warpgroup's rows, a tile's 32 q rows its
//                 columns); dv += T(P)^T dout and dk += dS^T q (hi, then
//                 lo) from registers, B the dout and Q tiles MN-major. The 32-row
//                 tile keeps the logits at 16 floats a thread beside dk and
//                 dv (2 x 64 at d = 128).
// A tile's logit products are two commit groups, S first: its
// exponentials run while dP is still in flight. dq, dk and dv's products
// are waited for before the next tile's (no overlap across tiles).
// Precision of the bf16 route:
//   - s and dP are f32 sums of bf16 products, exact in f32, in the tensor
//     cores' order (a few f32 ulps from the plain version's GEMM); the
//     exponentials are exp2 of the logits times scale log2(e) (m in those
//     units in the stats), and P is exp2(s - m) times 1 / max(l, 1e-30):
//     a few f32 ulps from exp(s - m) / l, for one MUFU op and one multiply
//     an element where an accurate exp and an IEEE division take many
//     (the kernels are bound by the issue of their softmax instructions
//     more than by their products);
//   - dS enters dq += dS k and dk += dS^T q as two bf16 A operands, hi =
//     bf16(dS) and lo = bf16(dS - hi), two products each, so dS is kept
//     to 2^-16. sum_j dS_ij = 0 cancels out of dq whatever the keys hold
//     in common, and a model's keys share a large common vector: dS
//     rounded to bf16 alone leaves 2^-9 of that vector's share in dq,
//     past the one-ulp limit (tests/test_torch_attention_grad.py,
//     `*common_component*`);
//   - dout: a bf16 cotangent (the model's: `ops.causal_attention` casts
//     out to bf16 inside its autograd Function, as the reference casts it
//     after `chunked_causal_attention`) is the operand as it is. An f32
//     dout is split as it is staged into hi = bf16(dout) and lo =
//     bf16(dout - hi): dP = hi v + lo v and dv += T(P)^T hi + T(P)^T lo
//     keep it to 2^-16. Rounded to bf16 alone, every operand of dP and dv
//     would move by up to 2^-9 of itself, as much as the one-ulp limit
//     allows the whole gradient;
//   - D_i = c_i + sum_j P_ij (dP_ij - c_i), c_i = dP_i0 (key 0, which
//     every row sees), from sweep 1's online sums (not dout_i . out_i,
//     which would need the forward's out). The shift makes D_i = c_i and
//     dS = 0 exactly on a row whose dP are all equal (row 1 when its two
//     dP round to one bf16 value: its gradient is 0), where the unshifted
//     sum leaves f32 rounding noise of either sign.
// The f32 route (bwd_dq_kernel, bwd_dkv_kernel): f32 FMAs on the CUDA
// cores for every product (an f32 product on the tensor cores would be
// TF32), each kernel a 16 x 16 grid of 256 threads over 64 x 64 tiles
// staged in shared memory (rows padded to d + 1 floats, so the 16 rows a
// half-warp reads for one column lie in 16 different banks); dout is f32.
//
// Bound: five products of 2 B Hq (N (N + 1) / 2) d flop (q.k, dout.v,
// dS.k, dS^T.q, P^T.dout) over the causal triangle; at granite-3-2b's 4 x
// 2048 rows, 32 q-heads of d = 64, 1.719e11 flop, 0.174 ms at the 989 TF/s
// bf16 peak. The f32 route makes nine (the dq kernel makes q.k and dout.v
// in each sweep, the dk/dv kernel both again) on the CUDA cores, whose f32
// peak is 67 TF/s; the bf16 route eleven on the tensor cores (dS.k and
// dS^T.q twice, hi and lo), fifteen with an f32 dout (dout.v and P^T.dout
// twice as well).
//
// MLA's latent shape (d = 576, dv = 512, one latent as K and V) takes a
// third route, bf16 only, whose note opens its section below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kB = 64;            // rows of a q-block, keys of a key block
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 tile entries
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// f32 route: f32 FMAs on the CUDA cores (instantiated with T = float only;
// bf16 takes the wgmma route below)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float widen(float x) { return x; }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }

// x rounded to T and widened back (the identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return widen(narrow<T>(x));
}

// The max / sum over the 16 lanes of a half-warp (the 16 threads that
// hold one row's entries of a tile); every lane gets the result.
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Stage rows [r0, r0 + 64) of a row-major [N][D] matrix into shared memory
// as f32 with row stride D + 1; rows past N are zero.
template <int D, typename S>
__device__ __forceinline__ void stage(float* dst, const S* src, int r0,
                                      int N) {
  for (int x = threadIdx.x; x < kB * D; x += kThreads) {
    const int r = x / D, c = x - r * D;
    dst[r * (D + 1) + c] =
        r0 + r < N ? widen(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// The thread's 4 x 4 entries of a 64 x 64 product a . b^T over D (rows
// ty + 16 i of a, rows tx + 16 j of b), f32 FMAs in order over D.
template <int D>
__device__ __forceinline__ void tile_dot(float out[4][4], const float* a,
                                         const float* b, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(av[i], bv[j], out[i][j]);
  }
}

// The scaled, masked logits and the rounded dP of the thread's entries:
// rows row0 + ty + 16 i, columns col0 + tx + 16 j (masked where the column
// lies past the row or past N, or the row past N).
template <typename T, int D>
__device__ __forceinline__ void logits_and_dp(
    float s[4][4], float dp[4][4], const float* qs, const float* ks,
    const float* dos, const float* vs, int tx, int ty, int row0, int col0,
    int N, float scale) {
  tile_dot<D>(s, qs, ks, tx, ty);
  tile_dot<D>(dp, dos, vs, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      const bool live = col <= row && col < N && row < N;
      s[i][j] = live ? __fmul_rn(s[i][j], scale) : kNegInf;
      dp[i][j] = round_to<T>(dp[i][j]);
    }
  }
}

// dq and the row statistics. Grid (ceil(N / 64), B * Hq); the late
// q-blocks, which walk the most key tiles, are launched first.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ dout,
    T* __restrict__ dq, float* __restrict__ stats, int N, int group,
    float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* qs = smem;
  float* dos = qs + kB * LD;
  float* ks = dos + kB * LD;
  float* vs = ks + kB * LD;
  float* dss = vs + kB * LD;                     // [64][65]
  const int nqb = (N + kB - 1) / kB;
  const int qb = nqb - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int bhk = bh / group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = qb * kB;
  const size_t nbh = (size_t)gridDim.y * N;
  const T* qh = q + (size_t)bh * N * D;
  const float* doh = dout + (size_t)bh * N * D;
  const T* kh = k + (size_t)bhk * N * D;
  const T* vh = v + (size_t)bhk * N * D;

  stage<D>(qs, qh, row0, N);
  stage<D>(dos, doh, row0, N);

  float m[4], l[4], dn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    dn[i] = 0.f;
  }
  float s[4][4], dp[4][4];
  // sweep 1: m, l and sum exp(s - m) dP, online
  for (int kt = 0; kt <= qb; ++kt) {
    __syncthreads();
    stage<D>(ks, kh, kt * kB, N);
    stage<D>(vs, vh, kt * kB, N);
    __syncthreads();
    logits_and_dp<T, D>(s, dp, qs, ks, dos, vs, tx, ty, row0, kt * kB, N,
                        scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_max(tmax));
      const float alpha = expf(m[i] - m_new);
      float le = 0.f, de = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        le += e;
        de = fmaf(e, dp[i][j], de);
      }
      l[i] = l[i] * alpha + half_sum(le);
      dn[i] = dn[i] * alpha + half_sum(de);
      m[i] = m_new;
    }
  }
  float lc[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lc[i] = fmaxf(l[i], 1e-30f);
    dd[i] = dn[i] / lc[i];
    const int row = row0 + ty + 16 * i;
    if (tx == 0 && row < N) {
      const size_t o = (size_t)bh * N + row;
      stats[o] = m[i];
      stats[nbh + o] = l[i];
      stats[2 * nbh + o] = dd[i];
    }
  }

  // sweep 2: dS, and dq += dS k
  constexpr int NC = D / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int kt = 0; kt <= qb; ++kt) {
    __syncthreads();
    stage<D>(ks, kh, kt * kB, N);
    stage<D>(vs, vh, kt * kB, N);
    __syncthreads();
    logits_and_dp<T, D>(s, dp, qs, ks, dos, vs, tx, ty, row0, kt * kB, N,
                        scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m[i]) / lc[i];
        dss[(ty + 16 * i) * (kB + 1) + tx + 16 * j] =
            __fmul_rn(p * (dp[i][j] - dd[i]), scale);
      }
    __syncthreads();
    for (int j = 0; j < kB; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dss[(ty + 16 * i) * (kB + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(d, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < N) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        dq[((size_t)bh * N + row) * D + tx + 16 * c] = narrow<T>(acc[i][c]);
    }
  }
}

// dk and dv. Grid (ceil(N / 64), B * Hk); runs after bwd_dq_kernel, whose
// stats it reads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
    int N, int group, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* ks = smem;
  float* vs = ks + kB * LD;
  float* qs = vs + kB * LD;
  float* dos = qs + kB * LD;
  float* ps = dos + kB * LD;                     // [64][65]: T(P)
  float* dss = ps + kB * (kB + 1);               // [64][65]: dS
  float* st = dss + kB * (kB + 1);               // m, 1 / max(l), D
  const int nqb = (N + kB - 1) / kB;
  const int kb = blockIdx.x;
  const int bhk = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int col0 = kb * kB;
  const size_t nbh = (size_t)gridDim.y * group * N;

  stage<D>(ks, k + (size_t)bhk * N * D, col0, N);
  stage<D>(vs, v + (size_t)bhk * N * D, col0, N);

  constexpr int NC = D / 16;
  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      gk[i][c] = 0.f;
      gv[i][c] = 0.f;
    }
  float s[4][4], dp[4][4];
  for (int h = 0; h < group; ++h) {
    const int bh = bhk * group + h;
    const T* qh = q + (size_t)bh * N * D;
    const float* doh = dout + (size_t)bh * N * D;
    for (int qb = kb; qb < nqb; ++qb) {
      const int row0 = qb * kB;
      __syncthreads();
      stage<D>(qs, qh, row0, N);
      stage<D>(dos, doh, row0, N);
      if (threadIdx.x < kB) {
        const int row = row0 + threadIdx.x;
        const size_t o = (size_t)bh * N + row;
        st[threadIdx.x] = row < N ? stats[o] : 0.f;
        st[kB + threadIdx.x] = row < N ? fmaxf(stats[nbh + o], 1e-30f) : 1.f;
        st[2 * kB + threadIdx.x] = row < N ? stats[2 * nbh + o] : 0.f;
      }
      __syncthreads();
      logits_and_dp<T, D>(s, dp, qs, ks, dos, vs, tx, ty, row0, col0, N,
                          scale);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float mi = st[r], li = st[kB + r], di = st[2 * kB + r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - mi) / li;
          ps[r * (kB + 1) + tx + 16 * j] = round_to<T>(p);
          dss[r * (kB + 1) + tx + 16 * j] =
              __fmul_rn(p * (dp[i][j] - di), scale);
        }
      }
      __syncthreads();
      for (int r = 0; r < kB; ++r) {
        float qv[NC], dv_[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          qv[c] = qs[r * LD + tx + 16 * c];
          dv_[c] = dos[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = ps[r * (kB + 1) + ty + 16 * i];
          const float dsv = dss[r * (kB + 1) + ty + 16 * i];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            gv[i][c] = fmaf(pv, dv_[c], gv[i][c]);
            gk[i][c] = fmaf(dsv, qv[c], gk[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = col0 + ty + 16 * i;
    if (col < N) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const size_t o = ((size_t)bhk * N + col) * D + tx + 16 * c;
        dk[o] = narrow<T>(gk[i][c]);
        dv[o] = narrow<T>(gv[i][c]);
      }
    }
  }
}

constexpr size_t dq_smem_bytes(int d) {
  return sizeof(float) * (4 * kB * (d + 1) + kB * (kB + 1));
}
constexpr size_t dkv_smem_bytes(int d) {
  return sizeof(float) * (4 * kB * (d + 1) + 2 * kB * (kB + 1) + 3 * kB);
}

// ---------------------------------------------------------------------------
// bf16 route: warpgroup products (wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // one warpgroup
constexpr int kQT = 32;           // dk/dv kernel: q rows a tile
constexpr int kDqStages = 2;      // dq kernel: K/V tiles in flight
constexpr int kDkvStages = 3;     // dk/dv kernel: q/dout tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// The 64-column blocks of a tile row of head dim d (d padded with zeros).
__host__ __device__ constexpr int blocks_of(int d) { return (d + 63) / 64; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(r[i]);
}

// Rows [r0, r0 + R) of a bf16 matrix [N][D] into the tile at shared
// address `dst` (blocks of R swizzled 128-byte rows), by cp.async (not
// waited for); zeros past N and past D.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int r0,
                                          int N) {
  constexpr int kCh = blocks_of(D) * 8;   // 16-byte chunks a padded row
#pragma unroll
  for (int i = 0; i < R * kCh / kTcThreads; ++i) {
    const int x = threadIdx.x + i * kTcThreads;
    const int r = x / kCh, c = x % kCh;
    const bool ok = r0 + r < N && c < D / 8;
    cp_async16(dst + (c >> 3) * (R * 128) + swz(r, c & 7),
               src + (ok ? (size_t)(r0 + r) * D + c * 8 : 0), ok);
  }
}

// The same rows of an f32 matrix, split into two bf16 tiles, hi = bf16(x)
// at `hi` and lo = bf16(x - hi) at `lo`, by plain loads and stores.
template <int D, int R>
__device__ __forceinline__ void split_tile(unsigned char* hi,
                                           unsigned char* lo,
                                           const float* src, int r0, int N) {
  constexpr int kCh = blocks_of(D) * 8;
#pragma unroll
  for (int i = 0; i < R * kCh / kTcThreads; ++i) {
    const int x = threadIdx.x + i * kTcThreads;
    const int r = x / kCh, c = x % kCh;
    uint4 h = make_uint4(0u, 0u, 0u, 0u), l = h;
    if (r0 + r < N && c < D / 8) {
      const float4* p = reinterpret_cast<const float4*>(
          src + (size_t)(r0 + r) * D + c * 8);
      const float4 a = __ldg(p), b = __ldg(p + 1);
      split_bf16(a.x, a.y, h.x, l.x);
      split_bf16(a.z, a.w, h.y, l.y);
      split_bf16(b.x, b.y, h.z, l.z);
      split_bf16(b.z, b.w, h.w, l.w);
    }
    const uint32_t off = (c >> 3) * (R * 128) + swz(r, c & 7);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Tiles 0 .. total - 1 through a ring of kStages stages, kStages - 1 in
// flight: load(i) issues tile i's copies into stage i % kStages; body(i)
// runs once every thread's copies of tile i have landed, and when it
// returns the CTA is done with tile i's stage (its products waited for).
// cp.async groups issued before the call are waited for with tile 0.
template <int kStages, typename Load, typename Body>
__device__ __forceinline__ void ring(int total, Load load, Body body) {
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load(i);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();       // this thread's copies of tile it
    fence_proxy_async();                // (and its stores) seen by wgmma
    __syncthreads();                    // everyone's; tile it - 1 is done
    if (it + kStages - 1 < total) load(it + kStages - 1);
    cp_async_commit();                  // (an empty group past the end)
    body(it);
  }
  __syncthreads();
}

// d (+)= A B^T over the D columns, issued for the warpgroup (the caller
// fences, commits and waits): A the 64-row tile at shared address a, B
// the RB-row tile at b (RB = 64: m64n64, 32: m64n32), both K-major; `acc`
// false overwrites d.
template <int D, int RB, int NR>
__device__ __forceinline__ void issue_kmajor(float (&d)[NR], uint32_t a,
                                             uint32_t b, bool acc) {
  static_assert(NR == RB / 2, "an m64nRB accumulator holds RB / 2 floats");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = gmma_desc(a + (kk >> 2) * (kB * 128) + off, 16, 1024);
    const uint64_t db = gmma_desc(b + (kk >> 2) * (RB * 128) + off, 16, 1024);
    if constexpr (RB == 64)
      wgmma_n64(d, da, db, acc || kk > 0);
    else
      wgmma_n32(d, da, db, acc || kk > 0);
  }
}

// d[nb] += A B, issued for the warpgroup: A [64 x 16 KS] bf16 from
// registers (a[kk]: k-step kk), B the tile at b, its KS x 16 rows (RB-row
// blocks) as the contraction and its D columns as the width (MN-major),
// one m64n64 product a 64-column block.
template <int D, int RB, int KS>
__device__ __forceinline__ void issue_rs(float (&d)[blocks_of(D)][32],
                                         const uint32_t (&a)[KS][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int nb = 0; nb < blocks_of(D); ++nb)
      wgmma_n64_rs_tb(d[nb], a[kk],
                      gmma_desc(b + nb * (RB * 128) + kk * 2048, RB * 128,
                                1024));
}

// The A fragments of a 64 x 16 KS accumulator's values, rounded to bf16:
// a[kk] covers its columns 16 kk .. 16 kk + 15.
template <int KS>
__device__ __forceinline__ void to_frag(uint32_t (&a)[KS][4],
                                        const float (&d)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// The same fragments of hi = bf16(d) and lo = bf16(d - hi): a product with
// A = hi, then one with A = lo, keeps d to 2^-16.
template <int KS>
__device__ __forceinline__ void split_frag(uint32_t (&hi)[KS][4],
                                           uint32_t (&lo)[KS][4],
                                           const float (&d)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1], hi[kk][i],
                 lo[kk][i]);
}

// The dq kernel's two products over one key tile, for the warpgroup's 64
// rows x 64 keys, issued as two groups: S = Q K^T into s, then dP = dout
// V^T into dp (dout's hi, then lo half when split, its tile after hi's).
template <int D, bool kSplit>
__device__ __forceinline__ void dq_issue(float (&s)[32], float (&dp)[32],
                                         uint32_t s_q, uint32_t s_do,
                                         uint32_t s_k, uint32_t s_v) {
  constexpr int kTile = blocks_of(D) * kB * 128;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  issue_kmajor<D, kB>(s, s_q, s_k, false);
  wgmma_commit();
  issue_kmajor<D, kB>(dp, s_do, s_v, false);
  if constexpr (kSplit) issue_kmajor<D, kB>(dp, s_do + kTile, s_v, true);
  wgmma_commit();
}

// Once S has landed (dP may still be in flight): s = S * sl (sl = scale
// log2(e): the logits in base-2 units), NEG_INF where the key lies past
// the row or past N, or the row past N (none of them where `full`); the
// thread's rows are ra (values 4 j + 0, 1) and ra + 8 (4 j + 2, 3).
__device__ __forceinline__ void dq_scores(float (&s)[32], int ra, int col0,
                                          int N, float sl, bool full) {
  wgmma_wait<1>();
  fence_regs(s);
  if (full) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], sl);
    return;
  }
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ra + 8 * (e >> 1), col = col0 + 8 * j + 2 * t + (e & 1);
      const bool live = col <= row && col < N && row < N;
      s[4 * j + e] = live ? __fmul_rn(s[4 * j + e], sl) : kNegInf;
    }
}

// Once every product has landed: dP rounded to bf16, T(dout . v).
template <int NR>
__device__ __forceinline__ void landed_dp(float (&dp)[NR]) {
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < NR; ++i) dp[i] = round_bf16(dp[i]);
}

// dq and the row statistics (bf16 route). Grid (ceil(N / 64), B * Hq); the
// late q-blocks are launched first. dout is f32 (kSplit) or bf16.
template <int D, bool kSplit>
__global__ void __launch_bounds__(kTcThreads, 1) bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const void* __restrict__ dout,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, int N,
    int group, float scale) {
  constexpr int NB = blocks_of(D);
  constexpr int kTile = NB * kB * 128;  // bytes of a 64-row tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* sm =                   // 1024-aligned: the swizzle's atoms
      tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  const uint32_t s_q = smem_u32(sm);
  const uint32_t s_do = s_q + kTile;    // dout, or its hi half, then lo
  const uint32_t s_ring = s_q + (kSplit ? 3 : 2) * kTile;  // K, V a stage
  const int nqb = (N + kB - 1) / kB;
  const int qb = nqb - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int bhk = bh / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qb * kB;
  const int ra = row0 + 16 * warp + g;  // the thread's rows: ra, ra + 8
  const bool full_rows = row0 + kB <= N;  // then key tiles before the
                                          // diagonal one need no mask
  const float sl = scale * kLog2e;
  const size_t nbh = (size_t)gridDim.y * N;
  const __nv_bfloat16* kh = k + (size_t)bhk * N * D;
  const __nv_bfloat16* vh = v + (size_t)bhk * N * D;

  load_tile<D, kB>(s_q, q + (size_t)bh * N * D, row0, N);
  if constexpr (kSplit)
    split_tile<D, kB>(sm + kTile, sm + 2 * kTile,
                      static_cast<const float*>(dout) + (size_t)bh * N * D,
                      row0, N);
  else
    load_tile<D, kB>(s_do,
                     static_cast<const __nv_bfloat16*>(dout) +
                         (size_t)bh * N * D,
                     row0, N);
  auto load = [&](int kt) {
    const uint32_t st = s_ring + (kt % kDqStages) * 2 * kTile;
    load_tile<D, kB>(st, kh, kt * kB, N);
    load_tile<D, kB>(st + kTile, vh, kt * kB, N);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  float c[2] = {0.f, 0.f};              // the rows' dP at key 0
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  // sweep 1: m, l and sum exp(s - m) (dP - c), online; exp(s - m) is
  // made while dP is in flight
  ring<kDqStages>(qb + 1, load, [&](int kt) {
    const uint32_t st = s_ring + (kt % kDqStages) * 2 * kTile;
    dq_issue<D, kSplit>(s, dp, s_q, s_do, st, st + kTile);
    dq_scores(s, ra, kt * kB, N, sl, kt < qb && full_rows);
    float m_new[2], alpha[2], le[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      m_new[h] = fmaxf(m[h], quad_max(tmax));
      alpha[h] = exp2f(m[h] - m_new[h]);
      le[h] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float e = exp2f(s[4 * j + 2 * h + x] - m_new[h]);
          s[4 * j + 2 * h + x] = e;
          le[h] += e;
        }
    }
    landed_dp(dp);
    if (kt == 0) {                      // key 0: lane t = 0 of the quad
      c[0] = __shfl_sync(kFull, dp[0], lane & ~3);
      c[1] = __shfl_sync(kFull, dp[2], lane & ~3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float de = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x)
          de = fmaf(s[4 * j + 2 * h + x], dp[4 * j + 2 * h + x] - c[h], de);
      l[h] = l[h] * alpha[h] + quad_sum(le[h]);
      dn[h] = dn[h] * alpha[h] + quad_sum(de);
      m[h] = m_new[h];
    }
  });
  float rl[2], dd[2];                   // 1 / max(l, 1e-30), D
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(l[h], 1e-30f);
    rl[h] = 1.f / lc;
    dd[h] = c[h] + dn[h] / lc;
    const int row = ra + 8 * h;
    if (t == 0 && row < N) {
      const size_t o = (size_t)bh * N + row;
      stats[o] = m[h];
      stats[nbh + o] = rl[h];
      stats[2 * nbh + o] = dd[h];
    }
  }

  // sweep 2: dS, and dq += dS k as (hi + lo) k
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  uint32_t a_hi[4][4], a_lo[4][4];
  ring<kDqStages>(qb + 1, load, [&](int kt) {
    const uint32_t st = s_ring + (kt % kDqStages) * 2 * kTile;
    dq_issue<D, kSplit>(s, dp, s_q, s_do, st, st + kTile);
    dq_scores(s, ra, kt * kB, N, sl, kt < qb && full_rows);
#pragma unroll
    for (int i = 0; i < 32; ++i)        // P, while dP is in flight
      s[i] = exp2f(s[i] - m[(i >> 1) & 1]) * rl[(i >> 1) & 1];
    landed_dp(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] = __fmul_rn(s[i] * (dp[i] - dd[(i >> 1) & 1]), scale);
    split_frag<4>(a_hi, a_lo, s);
    fence_regs(acc);
    wgmma_fence();
    issue_rs<D, kB, 4>(acc, a_hi, st);
    issue_rs<D, kB, 4>(acc, a_lo, st);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    if (row >= N) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * N + row) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nb + 8 * j + 2 * t;
        if (col < D)
          *reinterpret_cast<uint32_t*>(out + col) =
              pack2(acc[nb][4 * j + 2 * h], acc[nb][4 * j + 2 * h + 1]);
      }
  }
}

// dk and dv (bf16 route). Grid (ceil(N / 64), B * Hk); runs after
// bwd_dq_tc_kernel, whose stats it reads. dout is f32 (kSplit) or bf16.
template <int D, bool kSplit>
__global__ void __launch_bounds__(kTcThreads, 1) bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const void* __restrict__ dout,
    const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int N, int group, float scale) {
  constexpr int NB = blocks_of(D);
  constexpr int kKV = NB * kB * 128;    // a 64-key K or V tile
  constexpr int kQ = NB * kQT * 128;    // a 32-row q or dout tile
  constexpr int kStage = (kSplit ? 3 : 2) * kQ;  // q, dout (hi, lo)
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* sm =
      tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  const uint32_t s_k = smem_u32(sm), s_v = s_k + kKV;
  const uint32_t s_ring = s_k + 2 * kKV;
  // each stage's rows' m, 1 / max(l, 1e-30) and D: [kDkvStages][3][kQT]
  float* st_ring = reinterpret_cast<float*>(sm + 2 * kKV +
                                            kDkvStages * kStage);
  const int kb = blockIdx.x;
  const int bhk = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = kb * kB;
  const int ka = col0 + 16 * warp + g;  // the thread's keys: ka, ka + 8
  const float sl = scale * kLog2e;
  const int nqt = (N + kQT - 1) / kQT;
  const int qt0 = col0 / kQT;           // the first q tile at or after it
  const int per_head = nqt - qt0;
  const size_t nbh = (size_t)gridDim.y * group * N;

  load_tile<D, kB>(s_k, k + (size_t)bhk * N * D, col0, N);
  load_tile<D, kB>(s_v, v + (size_t)bhk * N * D, col0, N);
  auto load = [&](int it) {
    const int bh = bhk * group + it / per_head;
    const int r0 = (qt0 + it % per_head) * kQT;
    const int stg = it % kDkvStages;
    const uint32_t dst = s_ring + stg * kStage;
    load_tile<D, kQT>(dst, q + (size_t)bh * N * D, r0, N);
    if constexpr (kSplit)
      split_tile<D, kQT>(sm + 2 * kKV + stg * kStage + kQ,
                         sm + 2 * kKV + stg * kStage + 2 * kQ,
                         static_cast<const float*>(dout) +
                             (size_t)bh * N * D,
                         r0, N);
    else
      load_tile<D, kQT>(dst + kQ,
                        static_cast<const __nv_bfloat16*>(dout) +
                            (size_t)bh * N * D,
                        r0, N);
    if (threadIdx.x < 3 * kQT) {        // the tile's rows' stats
      const int w = threadIdx.x / kQT, r = threadIdx.x % kQT;
      const bool ok = r0 + r < N;
      cp_async4(smem_u32(st_ring + (stg * 3 + w) * kQT + r),
                stats + w * nbh + (ok ? (size_t)bh * N + r0 + r : 0), ok);
    }
  };

  float gk[NB][32], gv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[nb][i] = gv[nb][i] = 0.f;
  float s[kQT / 2], dp[kQT / 2];
#pragma unroll
  for (int i = 0; i < kQT / 2; ++i) s[i] = dp[i] = 0.f;
  uint32_t pa[kQT / 16][4], da_hi[kQT / 16][4], da_lo[kQT / 16][4];
  ring<kDkvStages>(group * per_head, load, [&](int it) {
    const int r0 = (qt0 + it % per_head) * kQT;
    const int stg = it % kDkvStages;
    const uint32_t s_qt = s_ring + stg * kStage, s_dt = s_qt + kQ;
    const float* st = st_ring + stg * 3 * kQT;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_kmajor<D, kQT>(s, s_k, s_qt, false);
    wgmma_commit();
    issue_kmajor<D, kQT>(dp, s_v, s_dt, false);
    if constexpr (kSplit) issue_kmajor<D, kQT>(dp, s_v, s_dt + kQ, true);
    wgmma_commit();
    wgmma_wait<1>();                    // S^T has landed; dP^T in flight
    fence_regs(s);
    // P (rows past N have m = 0 and 1 / l = 0 in the stage); a tile wholly
    // at or below the key block's last key and inside N needs no mask
    if (col0 + kB - 1 <= r0 && r0 + kQT <= N && col0 + kB <= N) {
#pragma unroll
      for (int j = 0; j < kQT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = 8 * j + 2 * t + (e & 1);
          s[4 * j + e] =
              exp2f(__fmul_rn(s[4 * j + e], sl) - st[lr]) * st[kQT + lr];
        }
    } else {
#pragma unroll
      for (int j = 0; j < kQT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ka + 8 * (e >> 1), lr = 8 * j + 2 * t + (e & 1);
          const int row = r0 + lr;
          const bool live = key <= row && row < N && key < N;
          const float x = live ? __fmul_rn(s[4 * j + e], sl) : kNegInf;
          s[4 * j + e] = exp2f(x - st[lr]) * st[kQT + lr];
        }
    }
    landed_dp(dp);
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = 8 * j + 2 * t + (e & 1);
        dp[4 * j + e] =
            __fmul_rn(s[4 * j + e] * (dp[4 * j + e] - st[2 * kQT + lr]),
                      scale);
      }
    to_frag<kQT / 16>(pa, s);           // T(P)
    split_frag<kQT / 16>(da_hi, da_lo, dp);  // dS as hi + lo
    fence_regs(gk);
    fence_regs(gv);
    wgmma_fence();
    issue_rs<D, kQT, kQT / 16>(gv, pa, s_dt);
    if constexpr (kSplit) issue_rs<D, kQT, kQT / 16>(gv, pa, s_dt + kQ);
    issue_rs<D, kQT, kQT / 16>(gk, da_hi, s_qt);
    issue_rs<D, kQT, kQT / 16>(gk, da_lo, s_qt);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(gk);
    fence_regs(gv);
  });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = ka + 8 * h;
    if (key >= N) continue;
    const size_t o = ((size_t)bhk * N + key) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nb + 8 * j + 2 * t;
        if (col < D) {
          *reinterpret_cast<uint32_t*>(dk + o + col) =
              pack2(gk[nb][4 * j + 2 * h], gk[nb][4 * j + 2 * h + 1]);
          *reinterpret_cast<uint32_t*>(dv + o + col) =
              pack2(gv[nb][4 * j + 2 * h], gv[nb][4 * j + 2 * h + 1]);
        }
      }
  }
}

constexpr size_t dq_tc_smem_bytes(int d, bool split) {
  return 1024 + (size_t)((split ? 3 : 2) + 2 * kDqStages) * blocks_of(d) *
                    kB * 128;
}
constexpr size_t dkv_tc_smem_bytes(int d, bool split) {
  return 1024 + (size_t)2 * blocks_of(d) * kB * 128 +
         (size_t)kDkvStages *
             ((split ? 3 : 2) * blocks_of(d) * kQT * 128 + 3 * kQT * 4);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename Kernel>
cudaError_t prefer_smem(Kernel kernel, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// The f32 route at head dim D.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, void* stats, int B, int Hq, int Hk,
           int N, float scale, cudaStream_t stream) {
  using T = float;
  const int group = Hq / Hk;
  const int nb = (N + kB - 1) / kB;
  auto kq = bwd_dq_kernel<T, D>;
  auto kkv = bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kq, dq_smem_bytes(D));
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kkv, dkv_smem_bytes(D));
  if (err != cudaSuccess) return (int)err;
  kq<<<dim3(nb, B * Hq), kThreads, dq_smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(dout),
      static_cast<T*>(dq), static_cast<float*>(stats), N, group, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(nb, B * Hk), kThreads, dkv_smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(stats), static_cast<T*>(dk),
      static_cast<T*>(dv), N, group, scale);
  return (int)cudaGetLastError();
}

// The bf16 route at head dim D, dout f32 (kSplit) or bf16.
template <int D, bool kSplit>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              void* dq, void* dk, void* dv, void* stats, int B, int Hq,
              int Hk, int N, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int group = Hq / Hk;
  const int nb = (N + kB - 1) / kB;
  auto kq = bwd_dq_tc_kernel<D, kSplit>;
  auto kkv = bwd_dkv_tc_kernel<D, kSplit>;
  const size_t smem_q = dq_tc_smem_bytes(D, kSplit);
  const size_t smem_kv = dkv_tc_smem_bytes(D, kSplit);
  cudaError_t err = prefer_smem(kq, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = prefer_smem(kkv, smem_kv);
  if (err != cudaSuccess) return (int)err;
  kq<<<dim3(nb, B * Hq), kTcThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, static_cast<T*>(dq),
      static_cast<float*>(stats), N, group, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(nb, B * Hk), kTcThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dout, static_cast<const float*>(stats),
      static_cast<T*>(dk), static_cast<T*>(dv), N, group, scale);
  return (int)cudaGetLastError();
}

// route 0: f32; 1: bf16, dout f32; 2: bf16, dout bf16.
int launch_d(int route, int d, const void* q, const void* k, const void* v,
             const void* dout, void* dq, void* dk, void* dv, void* stats,
             int B, int Hq, int Hk, int N, float scale, cudaStream_t s) {
#define BWD_CASE(D)                                                          \
  case D:                                                                    \
    if (route == 0)                                                          \
      return launch<D>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N,       \
                       scale, s);                                            \
    if (route == 1)                                                          \
      return launch_tc<D, true>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, \
                                N, scale, s);                                \
    return launch_tc<D, false>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk,  \
                               N, scale, s);
  switch (d) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(48)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(96)
    BWD_CASE(112)
    BWD_CASE(128)
  }
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// latent route: MLA's absorbed attention (d = 576 over one latent "kv head",
// V its first 512 columns), bf16, warpgroup products (wgmma)
// ---------------------------------------------------------------------------
//
// The backward of the prompt attention that `mla_train` (models/mla.py)
// runs, `ops.causal_attention(q_full, u[:, None], u[:, None, :, :512])`:
// q [B, Hq, N, 576] (deepseek-v3: Hq = 128) over the latent u [B, 1, N,
// 576] as K, V the view of its first 512 columns, scale 1/sqrt(192) passed
// in; dout [B, Hq, N, 512] f32 (the model's: its ctx stays f32 up to the
// W_uv product) or bf16. The function and the rounding points are the
// GQA routes' above (`ref.flash_prefill_bwd_ref`), with dv = 512 != d, but
// what it returns is dq and the latent's whole gradient
//   du_j = T(sum over q-heads and rows i >= j of dS_ij q_i
//            + [T(P_ij) dout_i, 0])      (u's 576 columns; dv's 512 first)
// summed in f32 and rounded once: K and V are one tensor, so training
// needs dk + [dv, 0], which autograd would otherwise add through the two
// views. Like the GQA routes it replaces no TPU kernel: the reference
// differentiates its MLA attention (src/repro/models/mla.py:114,
// `chunked_causal_attention` at the latent shape) with plain XLA
// autodiff, and the port's forward there is flash_prefill.cu's latent
// route, which has no gradient.
//
// Bound: the five products over the causal triangle, q.k, dS.k and dS^T.q
// over 576 and dout.v and P^T.dout over 512: B Hq N (N + 1) (3 576 + 2
// 512) flop, 5.913e12 at B = 4, N = 2048, 5.98 ms at the 989 TF/s bf16
// peak; the bytes (q and dq, an f32 dout, u and du, each moved once: 4.58
// GB) take 1.37 ms.
//
// Four kernels on one stream:
// - split_dout_kernel (an f32 dout only): hi = bf16(dout) and lo =
//   bf16(dout - hi) into a [2, B, Hq, N, 512] bf16 scratch, one elementwise
//   pass (the values split_bf16 gives), so both kernels below stage an f32
//   dout's tiles by cp.async like any bf16 tile, in their rings.
// - bwd_dq_latent_kernel: one CTA of two warpgroups per (q-head, 64-row
//   q-block), the late q-blocks first, Q and dout (hi, lo) resident, latent
//   tiles of kT keys streamed through two stages. Warpgroup 0 makes S = Q
//   K^T and the online statistics, warpgroup 1 dP = dout V^T, both m64nkT
//   from shared memory; dP (bf16) goes to warpgroup 0 and P (f32) to
//   warpgroup 1 through shared memory in the accumulators' fragment order,
//   one CTA barrier a tile; each warpgroup makes dS (bf16 hi and lo) and
//   adds dS K into its own dq column blocks from registers.
//   Two sweeps: the first makes m, l and D, the second dq (the GQA
//   routes' note above: D from the swept dP).
// - bwd_du_latent_kernel: one CTA per (b, slice of up to 16 q-heads,
//   64-key block), the 64-key latent tile resident, q and dout tiles of kR
//   rows (with their rows' m, 1 / l and D) through two stages. Warpgroup 0
//   makes S^T = K Q^T and P^T once a tile, warpgroup 1 dP^T = V dout^T;
//   they trade dP^T and P^T as in the dq kernel, each makes dS^T (hi, lo)
//   and T(P^T), and adds dS^T q into its du column blocks (0-4, 5-8) and
//   T(P)^T dout into the same accumulators' first 512 columns (0-4, 5-7):
//   one 64 x 576 f32 sum, dk's register footprint, so no CTA makes dv
//   apart and S^T is made once a tile. Each slice's sum goes to an f32
//   partial [slices, B, N, 576].
// - sum_slices_kernel: adds the slices in order and rounds du to bf16.
// Each output element is summed by one thread in a fixed order, with no
// atomics: two launches give the same bits.
//
// Tiles and shared memory (a CTA may have 232,448 bytes; 1,024 of them
// align the swizzle's atoms):
//   dq, bf16 dout   kT = 32: Q 73,728 + dout 65,536 + 2 x 36,864 tiles +
//                   12,288 exchange (dP bf16, P f32) = 226,304.
//   dq, f32 dout    Q, dout hi and lo (200 KB) leave 26 KB, one 16-key
//                   tile: a single stage. So warpgroup 0 holds q's last
//                   three column blocks as A fragments in registers (48 a
//                   thread: the accumulator block that its dq share of
//                   four leaves spare beside warpgroup 1's five, and 16
//                   more), which frees 24 KB: kT = 16, Q 49,152 + dout
//                   131,072 + 2 x 18,432 + 6,144 = 224,256, two tiles in
//                   flight.
//   du, bf16 dout   kR = 32: the latent tile 73,728 + 2 x (36,864 q +
//                   32,768 dout) + 768 stats + 12,288 exchange (dP^T bf16,
//                   P^T f32) = 227,072.
//   du, f32 dout    kR = 16 (dout's two halves make a 32-row stage 100 KB):
//                   73,728 + 2 x (18,432 + 2 x 16,384) + 384 + 6,144 =
//                   183,680.
// What limits such a route, and what this design does about each: m64n16
// logits re-read A (Q, or the latent tile) from shared memory for every
// 16 keys or rows: m64n32 where the shared memory holds 32-row tiles (a
// bf16 dout), halving those reads; an f32 dout split by plain loads
// inside a ring stalls it, and its halves beside Q leave the dq kernel
// one stage: one split pass, then cp.async at both cotangents, two stages
// everywhere; a dk and a dv CTA apart would make S four times in all and
// idle a warpgroup while dv's CTA makes S^T: du in one CTA makes it three
// times (two sweeps and the du kernel), and no CTA idles a warpgroup.
// What still holds it back: every logit product takes A from shared
// memory at n16 or n32 (2 KB of A for 16 or 32 columns of output), and
// with an f32 dout dP takes two such products: the shared memory's
// bandwidth bounds them, and they take most of the f32-dout dq kernel's
// time; the dq kernel makes S and dP twice; the du kernel's q and dout
// tiles are copied again by every key block at or before their rows, and
// two stages do not hide the copies wholly; the registers are full (the
// tile loader's offsets are made afresh in the f32-dout dq kernel, which
// spills otherwise); a tile's products are waited for before the next
// tile's (each warpgroup's CUDA-core work overlaps only the other's
// products: with two stages, a tile's logits issued before the last
// tile's products would leave its copies no time to land); the exchange
// costs a CTA barrier a tile beside the ring's.

constexpr int kLatD = 576;                // kv_lora + qk_rope: q and K
constexpr int kLatDV = 512;               // kv_lora: V, dout
constexpr int kLatNB = kLatD / 64;        // 64-column blocks of q and K: 9
constexpr int kLatVB = kLatDV / 64;       // of V and dout: 8
constexpr int kLatThreads = 256;          // two warpgroups
constexpr int kLat64 = kB * 128;          // a block of a 64-row tile
constexpr int kLatQ = kLatNB * kLat64;    // 64 rows of q or K: 73,728
constexpr int kLatDo = kLatVB * kLat64;   // 64 rows of dout: 65,536
constexpr int kLatXch = 128 * 16;         // an exchange slot: a uint4 a thread

// The dq kernel's shapes (kSplit: an f32 dout, as bf16 hi and lo).
template <bool kSplit>
struct LatDq {
  static constexpr int kT = kSplit ? 16 : 32;  // keys a latent tile
  static constexpr int kKS = kT / 16;          // its k-steps in dS K
  static constexpr int kQR = kSplit ? 3 : 0;   // q's blocks in registers
  static constexpr int kQS = kLatNB - kQR;     // q's blocks in shared memory
  static constexpr int kW0 = 4;                // warpgroup 0's dq blocks
  static constexpr int kAcc = kLatNB - kW0;    // accumulator blocks a thread
  static constexpr int kQX = kSplit ? 16 : 1;  // q's floats past acc[kW0]
  static constexpr int kTile = kLatNB * kT * 128;
  static constexpr int kDo = (kSplit ? 2 : 1) * kLatDo;
  static constexpr size_t kSmem = 1024 + (size_t)kQS * kLat64 + kDo +
                                  2 * (size_t)kTile + kKS * kLatXch +
                                  kT * 256;
};
static_assert(16 * LatDq<true>::kQR ==
                  32 * (LatDq<true>::kAcc - LatDq<true>::kW0) +
                      LatDq<true>::kQX,
              "q's register blocks fill warpgroup 0's spare accumulator "
              "block and the 16 floats past it");

// The du kernel's shapes.
template <bool kSplit>
struct LatDu {
  static constexpr int kR = kSplit ? 16 : 32;  // q rows a tile
  static constexpr int kKS = kR / 16;          // its k-steps in the du sums
  static constexpr int kQT = kLatNB * kR * 128;   // a q tile
  static constexpr int kDoT = kLatVB * kR * 128;  // a dout tile (a half)
  static constexpr int kStage = kQT + (kSplit ? 2 : 1) * kDoT;
  static constexpr int kW0 = 5;                // warpgroup 0's du blocks
  static constexpr size_t kSmem = 1024 + (size_t)kLatQ + 2 * (size_t)kStage +
                                  2 * 3 * kR * sizeof(float) +
                                  kKS * kLatXch + kR * 256;
};
static_assert(LatDq<false>::kSmem <= 232448 && LatDq<true>::kSmem <= 232448 &&
                  LatDu<false>::kSmem <= 232448 &&
                  LatDu<true>::kSmem <= 232448,
              "a latent kernel's shared memory exceeds an sm_90 CTA's");

// The thread's warpgroup (0 or 1), as a value the compiler knows to be the
// same across the warp, so the warpgroups' products in their branches
// are not serialised.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(kFull, (int)threadIdx.x >> 7, 0);
}

// Rows [r0, r0 + R) of a bf16 matrix with rows of D elements (zeros past
// N), its column blocks 0 .. NBL - 1, into the tile at shared address dst:
// NBL blocks of R swizzled 128-byte rows, by cp.async (not waited for); all
// 256 threads. Chunk x of the tile, block-major (8 R 16-byte chunks a
// block), goes to thread x % 256: a thread keeps its chunk of a row, c =
// x % 8, in every block, and a warp reads four 128-byte row segments.
// kFresh reads the thread index afresh (volatile), so the offsets are
// made at each call and not held in registers across a tile loop: the
// f32-dout dq kernel, whose registers are full, spills without it (and
// the bf16-dout du kernel with it).
template <int D, int R, int NBL = D / 64, bool kFresh = false>
__device__ __forceinline__ void lat_load(uint32_t dst,
                                         const __nv_bfloat16* src, int r0,
                                         int N) {
  constexpr int kCB = 8 * R;              // chunks a block (a power of 2)
  constexpr int kAll = kCB * NBL;
  int tid = threadIdx.x;
  if constexpr (kFresh) asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  const int c = tid & 7;
#pragma unroll
  for (int i = 0; i < (kAll + kLatThreads - 1) / kLatThreads; ++i) {
    const int x = tid + i * kLatThreads;
    if (kAll % kLatThreads != 0 && x >= kAll) break;
    const int blk = x / kCB, r = (x >> 3) & (R - 1);
    const bool ok = r0 + r < N;
    cp_async16(dst + blk * (R * 128) + swz(r, c),
               src + (ok ? (size_t)(r0 + r) * D + blk * 64 + c * 8 : 0),
               ok);
  }
}

// s[64 x 16] += a b on the tensor cores, for the warpgroup: a [64 x 16]
// bf16 from registers (the A fragment layout above), b [16 x 16] K-major
// bf16 in shared memory by descriptor.
__device__ __forceinline__ void wgmma_n16_rs(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= A B^T over the k-steps K0 .. K0 + KS - 1 (16 columns each), issued
// for the warpgroup (the caller fences, commits and waits): A the 64-row
// tile at a, B the R-row tile at b, both K-major in 64-column blocks; m64nR
// products (R = 16 or 32); `acc` false overwrites d at the first.
template <int K0, int KS, int R>
__device__ __forceinline__ void lat_nt(float (&d)[R / 2], uint32_t a,
                                       uint32_t b, bool acc) {
#pragma unroll
  for (int kk = K0; kk < K0 + KS; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = gmma_desc(a + (kk >> 2) * kLat64 + off, 16, 1024);
    const uint64_t db = gmma_desc(b + (kk >> 2) * (R * 128) + off, 16, 1024);
    const int on = acc || kk > K0;
    if constexpr (R == 32)
      wgmma_n32(d, da, db, on);
    else
      wgmma_n16(reinterpret_cast<float(&)[2][4]>(d), da, db, on);
  }
}

// s += Q B^T over the k-steps K0 .. K0 + KS - 1 with Q's A fragments from
// registers: k-step K0 + i in floats 4 i .. 4 i + 3 of qa, then qx (bf16
// pairs as float bits); B the 16-row tile at b, K-major; m64n16 products.
template <int K0, int KS, int NX>
__device__ __forceinline__ void lat_nt_qreg(float (&d)[8],
                                            const float (&qa)[32],
                                            const float (&qx)[NX],
                                            uint32_t b) {
  static_assert(4 * KS == 32 + NX, "qa and qx hold the k-steps");
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int kk = K0 + i;
    uint32_t a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * i + e;
      a[e] = __float_as_uint(x < 32 ? qa[x] : qx[x - 32]);
    }
    wgmma_n16_rs(d, a, gmma_desc(b + (kk >> 2) * (16 * 128) + (kk & 3) * 32,
                                 16, 1024));
  }
}

// d[i] += A B over the column blocks NB0 .. NB0 + NBW - 1 of B, issued for
// the warpgroup: A (a[kk], k-step kk) bf16 from registers, B the R-row tile
// at b, MN-major (its rows the contraction).
template <int NB0, int NBW, int R, int NA>
__device__ __forceinline__ void lat_rs(float (&d)[NA][32],
                                       const uint32_t (&a)[R / 16][4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
    for (int i = 0; i < NBW; ++i)
      wgmma_n64_rs_tb(d[i], a[kk],
                      gmma_desc(b + (NB0 + i) * (R * 128) + kk * 2048,
                                R * 128, 1024));
}

// The A fragments a[kk] (bf16 pairs) to exchange slot x (KS uint4 a
// thread), and back.
template <int KS>
__device__ __forceinline__ void lat_put(uint4* x, const uint32_t (&a)[KS][4],
                                        int wt) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    x[kk * 128 + wt] = make_uint4(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
}
template <int KS>
__device__ __forceinline__ void lat_get(uint32_t (&a)[KS][4], const uint4* x,
                                        int wt) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint4 w = x[kk * 128 + wt];
    a[kk][0] = w.x;
    a[kk][1] = w.y;
    a[kk][2] = w.z;
    a[kk][3] = w.w;
  }
}
// An accumulator's NF floats to exchange slot x (NF / 4 float4 a thread),
// and back.
template <int NF>
__device__ __forceinline__ void lat_putf(float4* x, const float (&v)[NF],
                                         int wt) {
#pragma unroll
  for (int i = 0; i < NF / 4; ++i)
    x[i * 128 + wt] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
template <int NF>
__device__ __forceinline__ void lat_getf(float (&v)[NF], const float4* x,
                                         int wt) {
#pragma unroll
  for (int i = 0; i < NF / 4; ++i) {
    const float4 w = x[i * 128 + wt];
    v[4 * i] = w.x;
    v[4 * i + 1] = w.y;
    v[4 * i + 2] = w.z;
    v[4 * i + 3] = w.w;
  }
}

// An accumulator's values from its bf16 fragments.
template <int KS>
__device__ __forceinline__ void lat_unfrag(float (&d)[8 * KS],
                                           const uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[8 * kk + 2 * i] = __uint_as_float(a[kk][i] << 16);
      d[8 * kk + 2 * i + 1] = __uint_as_float(a[kk][i] & 0xffff0000u);
    }
}

// dp = T(A B^T) over the 512 dims of V and dout, waited for, as bf16 A
// fragments: A the 64-row tile at a, B the R-row tile at b; an f32 dout is
// its hi half, then its lo half (lo_a bytes past A's address, or lo_b past
// B's).
template <bool kSplit, int R>
__device__ __forceinline__ void lat_dp(uint32_t (&f)[R / 16][4], uint32_t a,
                                       uint32_t b, uint32_t lo_a,
                                       uint32_t lo_b) {
  float dp[R / 2];
#pragma unroll
  for (int i = 0; i < R / 2; ++i) dp[i] = 0.f;
  fence_regs(dp);
  wgmma_fence();
  lat_nt<0, 4 * kLatVB, R>(dp, a, b, false);
  if constexpr (kSplit) lat_nt<0, 4 * kLatVB, R>(dp, a + lo_a, b + lo_b, true);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(dp);
  to_frag<R / 16>(f, dp);
}

// dq and the row statistics of the latent route. Grid (ceil(N / 64),
// B * Hq), the late q-blocks first; q [B*Hq, N, 576], the latent [B, N,
// 576], dout [B*Hq, N, 512] bf16 (kSplit: its hi half, the lo half lo_off
// elements after it).
template <bool kSplit>
__global__ void __launch_bounds__(kLatThreads, 1) bwd_dq_latent_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ lat,
    const __nv_bfloat16* __restrict__ dout, size_t lo_off,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ stats, int N,
    int Hq, float scale) {
  using L = LatDq<kSplit>;
  constexpr int kT = L::kT, kKS = L::kKS, kQS = L::kQS, kW0 = L::kW0;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* sm =
      tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  const uint32_t s_q = smem_u32(sm);
  const uint32_t s_do = s_q + kQS * kLat64;  // dout, or hi, then lo
  const uint32_t s_ring = s_do + L::kDo;
  uint4* xdp = reinterpret_cast<uint4*>(sm + kQS * kLat64 + L::kDo +
                                        2 * L::kTile);   // dP, bf16
  float4* xp = reinterpret_cast<float4*>(xdp + kKS * 128);  // P, f32
  const int nqb = (N + kB - 1) / kB;
  const int qb = nqb - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int wg = warpgroup(), wt = threadIdx.x & 127;
  const int warp = wt >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qb * kB;
  const int ra = row0 + 16 * warp + g;  // the thread's rows: ra, ra + 8
  const bool full_rows = row0 + kB <= N;
  const int ntiles = min((qb + 1) * (kB / kT), (N + kT - 1) / kT);
  const int nfull = qb * (kB / kT);     // tiles wholly before row0
  const float sl = scale * kLog2e;
  const size_t nbh = (size_t)gridDim.y * N;
  const __nv_bfloat16* kh = lat + (size_t)(bh / Hq) * N * kLatD;
  const __nv_bfloat16* qh = q + (size_t)bh * N * kLatD;

  lat_load<kLatD, kB, kQS>(s_q, qh, row0, N);
  lat_load<kLatDV, kB>(s_do, dout + (size_t)bh * N * kLatDV, row0, N);
  if constexpr (kSplit)
    lat_load<kLatDV, kB>(s_do + kLatDo,
                         dout + lo_off + (size_t)bh * N * kLatDV, row0, N);
  float acc[L::kAcc][32], qx[L::kQX];
#pragma unroll
  for (int i = 0; i < L::kAcc; ++i)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[i][x] = 0.f;
  // warpgroup 0: q's last kQR blocks as A fragments (k-step i of them in
  // floats 4 i .. 4 i + 3 of acc[kW0], then qx), from device memory
  if constexpr (L::kQR > 0) {
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 4 * L::kQR; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = ra + 8 * (e & 1);
          const int col = 64 * kQS + 16 * i + 8 * (e >> 1) + 2 * t;
          const float w = __uint_as_float(
              row < N ? *reinterpret_cast<const uint32_t*>(
                            qh + (size_t)row * kLatD + col)
                      : 0u);
          if (4 * i + e < 32)
            acc[kW0][4 * i + e] = w;
          else
            qx[4 * i + e - 32] = w;
        }
    }
  }
  auto load = [&](int kt) {
    lat_load<kLatD, kT, kLatNB, true>(s_ring + (kt & 1) * L::kTile, kh,
                                      kt * kT, N);
  };
  // warpgroup 0: the tile's logits in base-2 units, masked
  auto logits = [&](float (&s)[kT / 2], uint32_t tile, int kt) {
    fence_regs(s);
    wgmma_fence();
    lat_nt<0, 4 * kQS, kT>(s, s_q, tile, false);
    if constexpr (L::kQR > 0)
      lat_nt_qreg<4 * kQS, 4 * L::kQR>(s, acc[kW0], qx, tile);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    const bool full = kt < nfull && full_rows;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + 8 * (e >> 1);
        const int col = kt * kT + 8 * j + 2 * t + (e & 1);
        const bool live = full || (col <= row && col < N && row < N);
        s[4 * j + e] = live ? __fmul_rn(s[4 * j + e], sl) : kNegInf;
      }
  };
  // warpgroup 1: the tile's dP, to the exchange (and to dp)
  auto dp_out = [&](uint32_t tile, float (&dp)[kT / 2]) {
    uint32_t f[kKS][4];
    lat_dp<kSplit, kT>(f, s_do, tile, kLatDo, 0);
    lat_put<kKS>(xdp, f, wt);
    lat_unfrag<kKS>(dp, f);
  };
  auto dp_in = [&](float (&dp)[kT / 2]) {
    uint32_t f[kKS][4];
    lat_get<kKS>(f, xdp, wt);
    lat_unfrag<kKS>(dp, f);
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, dn[2] = {0.f, 0.f};
  float c[2] = {0.f, 0.f};              // the rows' dP at key 0
  float s[kT / 2], dp[kT / 2];
#pragma unroll
  for (int i = 0; i < kT / 2; ++i) s[i] = dp[i] = 0.f;
  // sweep 1: m, l and sum exp(s - m) (dP - c), online
  ring<2>(ntiles, load, [&](int kt) {
    const uint32_t tile = s_ring + (kt & 1) * L::kTile;
    float m_new[2], alpha[2], le[2];
    if (wg == 0) {
      logits(s, tile, kt);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = kNegInf;
#pragma unroll
        for (int j = 0; j < kT / 8; ++j)
          tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        m_new[h] = fmaxf(m[h], quad_max(tmax));
        alpha[h] = exp2f(m[h] - m_new[h]);
        le[h] = 0.f;
#pragma unroll
        for (int j = 0; j < kT / 8; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float e = exp2f(s[4 * j + 2 * h + x] - m_new[h]);
            s[4 * j + 2 * h + x] = e;
            le[h] += e;
          }
      }
    } else {
      dp_out(tile, dp);
    }
    __syncthreads();
    if (wg == 0) {
      dp_in(dp);
      if (kt == 0) {                    // key 0: lane t = 0 of the quad
        c[0] = __shfl_sync(kFull, dp[0], lane & ~3);
        c[1] = __shfl_sync(kFull, dp[2], lane & ~3);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float de = 0.f;
#pragma unroll
        for (int j = 0; j < kT / 8; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            de = fmaf(s[4 * j + 2 * h + x], dp[4 * j + 2 * h + x] - c[h], de);
        l[h] = l[h] * alpha[h] + quad_sum(le[h]);
        dn[h] = dn[h] * alpha[h] + quad_sum(de);
        m[h] = m_new[h];
      }
    }
  });
  float rl[2], dd[2];                   // 1 / max(l, 1e-30), D
  float* xdd = reinterpret_cast<float*>(xp);  // D, to warpgroup 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lc = fmaxf(l[h], 1e-30f);
    rl[h] = 1.f / lc;
    dd[h] = c[h] + dn[h] / lc;
    const int row = ra + 8 * h;
    if (wg == 0) xdd[2 * wt + h] = dd[h];
    if (wg == 0 && t == 0 && row < N) {
      const size_t o = (size_t)bh * N + row;
      stats[o] = m[h];
      stats[nbh + o] = rl[h];
      stats[2 * nbh + o] = dd[h];
    }
  }
  __syncthreads();
  if (wg == 1) {
    dd[0] = xdd[2 * wt];
    dd[1] = xdd[2 * wt + 1];
  }

  // sweep 2: P goes to warpgroup 1 and dP to warpgroup 0; each makes dS
  // and adds dS k into its dq columns as (hi + lo) k
  uint32_t a_hi[kKS][4], a_lo[kKS][4];
  ring<2>(ntiles, load, [&](int kt) {
    const uint32_t tile = s_ring + (kt & 1) * L::kTile;
    if (wg == 0) {
      logits(s, tile, kt);
#pragma unroll
      for (int i = 0; i < kT / 2; ++i)
        s[i] = exp2f(s[i] - m[(i >> 1) & 1]) * rl[(i >> 1) & 1];
      lat_putf<kT / 2>(xp, s, wt);
    } else {
      dp_out(tile, dp);
    }
    __syncthreads();
    if (wg == 0)
      dp_in(dp);
    else
      lat_getf<kT / 2>(s, xp, wt);
#pragma unroll
    for (int i = 0; i < kT / 2; ++i)
      s[i] = __fmul_rn(s[i] * (dp[i] - dd[(i >> 1) & 1]), scale);
    split_frag<kKS>(a_hi, a_lo, s);
    fence_regs(acc);
    wgmma_fence();
    if (wg == 0) {
      lat_rs<0, kW0, kT>(acc, a_hi, tile);
      lat_rs<0, kW0, kT>(acc, a_lo, tile);
    } else {
      lat_rs<kW0, kLatNB - kW0, kT>(acc, a_hi, tile);
      lat_rs<kW0, kLatNB - kW0, kT>(acc, a_lo, tile);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  });
  const int nb0 = wg == 0 ? 0 : kW0;
  const int nbw = wg == 0 ? kW0 : kLatNB - kW0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    if (row >= N) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * N + row) * kLatD;
#pragma unroll
    for (int i = 0; i < L::kAcc; ++i) {
      if (i >= nbw) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * (nb0 + i) + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(out + col) =
            pack2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
      }
    }
  }
}

// The latent's gradient over one slice of the q-heads: one CTA per (b,
// slice, 64-key block), du += dS^T q (hi, then lo) + [T(P)^T dout, 0]
// over the slice's heads in order, then the kR-row q tiles at or after
// the key block, into part[slice][b][key][576] f32. The 1-D grid holds
// the (b, slice) streams fastest, so the CTAs in flight hold a few
// neighbouring key blocks of every stream (the key blocks of one stream
// fastest measured slower on the card). Runs after bwd_dq_latent_kernel,
// whose stats it reads; dout as there.
template <bool kSplit>
__global__ void __launch_bounds__(kLatThreads, 1) bwd_du_latent_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ lat,
    const __nv_bfloat16* __restrict__ dout, size_t lo_off,
    const float* __restrict__ stats, float* __restrict__ part, int B, int N,
    int Hq, int slices, float scale) {
  using L = LatDu<kSplit>;
  constexpr int kR = L::kR, kKS = L::kKS, kW0 = L::kW0;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* sm =
      tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  const uint32_t s_k = smem_u32(sm);
  const uint32_t s_ring = s_k + kLatQ;
  float* st_ring =                      // [2][3][kR]: m, 1 / l, D
      reinterpret_cast<float*>(sm + kLatQ + 2 * L::kStage);
  uint4* xdp = reinterpret_cast<uint4*>(st_ring + 2 * 3 * kR);  // dP^T
  float4* xp = reinterpret_cast<float4*>(xdp + kKS * 128);  // P^T, f32
  const int nbs = B * slices;
  const int cta = blockIdx.x;
  const int bs = cta % nbs, kb = cta / nbs;
  const int b = bs / slices, slice = bs % slices;
  const int hs = Hq / slices;
  const int col0 = kb * kB;
  const int wg = warpgroup(), wt = threadIdx.x & 127;
  const int warp = wt >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ka = col0 + 16 * warp + g;  // the thread's keys: ka, ka + 8
  const float sl = scale * kLog2e;
  const int nqt = (N + kR - 1) / kR;
  const int qt0 = col0 / kR;            // the first q tile at or after it
  const int per_head = nqt - qt0;
  const size_t nbh = (size_t)B * Hq * N;

  lat_load<kLatD, kB>(s_k, lat + (size_t)b * N * kLatD, col0, N);
  auto load = [&](int it) {
    const int bh = b * Hq + slice * hs + it / per_head;
    const int r0 = (qt0 + it % per_head) * kR;
    const int stg = it & 1;
    const uint32_t dst = s_ring + stg * L::kStage;
    const __nv_bfloat16* dh = dout + (size_t)bh * N * kLatDV;
    lat_load<kLatD, kR>(dst, q + (size_t)bh * N * kLatD, r0, N);
    lat_load<kLatDV, kR>(dst + L::kQT, dh, r0, N);
    if constexpr (kSplit)
      lat_load<kLatDV, kR>(dst + L::kQT + L::kDoT, dh + lo_off, r0, N);
    if (threadIdx.x < 3 * kR) {         // the tile's rows' stats
      const int w = threadIdx.x / kR, r = threadIdx.x % kR;
      const bool ok = r0 + r < N;
      cp_async4(smem_u32(st_ring + (stg * 3 + w) * kR + r),
                stats + w * nbh + (ok ? (size_t)bh * N + r0 + r : 0), ok);
    }
  };

  float acc[kW0][32];
#pragma unroll
  for (int i = 0; i < kW0; ++i)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[i][x] = 0.f;
  float s[kR / 2], dp[kR / 2];
#pragma unroll
  for (int i = 0; i < kR / 2; ++i) s[i] = dp[i] = 0.f;
  uint32_t a_hi[kKS][4], a_lo[kKS][4], a_p[kKS][4];
  ring<2>(hs * per_head, load, [&](int it) {
    const int r0 = (qt0 + it % per_head) * kR;
    const int stg = it & 1;
    const uint32_t s_qt = s_ring + stg * L::kStage, s_dt = s_qt + L::kQT;
    const float* st = st_ring + stg * 3 * kR;
    if (wg == 0) {                      // P^T (rows past N: m = 0, 1/l = 0)
      fence_regs(s);
      wgmma_fence();
      lat_nt<0, 4 * kLatNB, kR>(s, s_k, s_qt, false);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      const bool full =
          col0 + kB - 1 <= r0 && r0 + kR <= N && col0 + kB <= N;
#pragma unroll
      for (int j = 0; j < kR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ka + 8 * (e >> 1), lr = 8 * j + 2 * t + (e & 1);
          const int row = r0 + lr;
          const bool live = full || (key <= row && row < N && key < N);
          const float x = live ? __fmul_rn(s[4 * j + e], sl) : kNegInf;
          s[4 * j + e] = exp2f(x - st[lr]) * st[kR + lr];
        }
      lat_putf<kR / 2>(xp, s, wt);
    } else {                            // dP^T, to the exchange
      uint32_t f[kKS][4];
      lat_dp<kSplit, kR>(f, s_k, s_dt, 0, L::kDoT);
      lat_put<kKS>(xdp, f, wt);
      lat_unfrag<kKS>(dp, f);
    }
    __syncthreads();
    if (wg == 0) {
      uint32_t f[kKS][4];
      lat_get<kKS>(f, xdp, wt);
      lat_unfrag<kKS>(dp, f);
    } else {
      lat_getf<kR / 2>(s, xp, wt);
    }
    // dS^T as hi and lo, and T(P^T), in each warpgroup
#pragma unroll
    for (int j = 0; j < kR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = 8 * j + 2 * t + (e & 1);
        dp[4 * j + e] =
            __fmul_rn(s[4 * j + e] * (dp[4 * j + e] - st[2 * kR + lr]),
                      scale);
      }
    split_frag<kKS>(a_hi, a_lo, dp);
    to_frag<kKS>(a_p, s);
    fence_regs(acc);
    wgmma_fence();
    if (wg == 0) {
      lat_rs<0, kW0, kR>(acc, a_hi, s_qt);
      lat_rs<0, kW0, kR>(acc, a_lo, s_qt);
      lat_rs<0, kW0, kR>(acc, a_p, s_dt);
      if constexpr (kSplit) lat_rs<0, kW0, kR>(acc, a_p, s_dt + L::kDoT);
    } else {
      lat_rs<kW0, kLatNB - kW0, kR>(acc, a_hi, s_qt);
      lat_rs<kW0, kLatNB - kW0, kR>(acc, a_lo, s_qt);
      lat_rs<kW0, kLatVB - kW0, kR>(acc, a_p, s_dt);
      if constexpr (kSplit)
        lat_rs<kW0, kLatVB - kW0, kR>(acc, a_p, s_dt + L::kDoT);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  });
  const int nb0 = wg == 0 ? 0 : kW0;
  const int nbw = wg == 0 ? kW0 : kLatNB - kW0;
  float* out = part + ((size_t)slice * B + b) * N * kLatD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = ka + 8 * h;
    if (key >= N) continue;
#pragma unroll
    for (int i = 0; i < kW0; ++i) {
      if (i >= nbw) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * (nb0 + i) + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(out + (size_t)key * kLatD + col) =
            make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
      }
    }
  }
}

// out[i] = bf16(the sum over s of part[s][i]), s in order, in f32; four
// elements a thread (count a multiple of 4).
__global__ void sum_slices_kernel(const float* __restrict__ part,
                                  __nv_bfloat16* __restrict__ out,
                                  size_t count, int slices) {
  const size_t stride = (size_t)gridDim.x * blockDim.x * 4;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i < count; i += stride) {
    float4 a = __ldg(reinterpret_cast<const float4*>(part + i));
    for (int sl = 1; sl < slices; ++sl) {
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(part + sl * count + i));
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    *reinterpret_cast<uint2*>(out + i) =
        make_uint2(pack2(a.x, a.y), pack2(a.z, a.w));
  }
}

// hi[i] = bf16(x[i]) and lo[i] = bf16(x[i] - hi[i]) (split_bf16's values),
// eight elements a thread (count a multiple of 8, 32-byte aligned rows).
__global__ void split_dout_kernel(const float* __restrict__ x,
                                  __nv_bfloat16* __restrict__ hi,
                                  __nv_bfloat16* __restrict__ lo,
                                  size_t count) {
  const size_t stride = (size_t)gridDim.x * blockDim.x * 8;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
       i < count; i += stride) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + i + 4));
    uint4 h, l;
    split_bf16(a.x, a.y, h.x, l.x);
    split_bf16(a.z, a.w, h.y, l.y);
    split_bf16(b.x, b.y, h.z, l.z);
    split_bf16(b.z, b.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

cudaError_t launch_split(const void* x, void* out, size_t count,
                         cudaStream_t stream) {
  auto* hi = static_cast<__nv_bfloat16*>(out);
  const size_t blocks = (count / 8 + 255) / 256;
  split_dout_kernel<<<(unsigned)(blocks < 2112 ? blocks : 2112), 256, 0,
                      stream>>>(static_cast<const float*>(x), hi, hi + count,
                                count);
  return cudaGetLastError();
}

template <bool kSplit>
int launch_latent(const void* q, const void* lat, const void* dout,
                  void* split, void* dq, void* du, void* stats, void* part,
                  int B, int Hq, int N, int slices, float scale,
                  cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int nb = (N + kB - 1) / kB;
  const size_t count = (size_t)B * Hq * N * kLatDV;
  cudaError_t err;
  if constexpr (kSplit) {
    err = launch_split(dout, split, count, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const T* d = static_cast<const T*>(kSplit ? split : dout);
  auto kq = bwd_dq_latent_kernel<kSplit>;
  auto ku = bwd_du_latent_kernel<kSplit>;
  err = prefer_smem(kq, LatDq<kSplit>::kSmem);
  if (err != cudaSuccess) return (int)err;
  err = prefer_smem(ku, LatDu<kSplit>::kSmem);
  if (err != cudaSuccess) return (int)err;
  kq<<<dim3(nb, B * Hq), kLatThreads, LatDq<kSplit>::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(lat), d, count,
      static_cast<T*>(dq), static_cast<float*>(stats), N, Hq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ku<<<B * slices * nb, kLatThreads, LatDu<kSplit>::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(lat), d, count,
      static_cast<const float*>(stats), static_cast<float*>(part), B, N, Hq,
      slices, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)B * N * kLatD;
  const size_t blocks = (total / 4 + 255) / 256;
  sum_slices_kernel<<<(unsigned)(blocks < 1056 ? blocks : 1056), 256, 0,
                      stream>>>(static_cast<const float*>(part),
                                static_cast<T*>(du), total, slices);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the largest of the kernels at head dim d (both
// routes, either dout), in bytes (0 for a d the kernels do not take).
size_t flash_prefill_bwd_smem_bytes(int d) {
  if (d <= 0 || d > kMaxD || d % 16) return 0;
  const size_t sizes[] = {dq_smem_bytes(d), dkv_smem_bytes(d),
                          dq_tc_smem_bytes(d, true),
                          dkv_tc_smem_bytes(d, true)};
  size_t most = 0;
  for (size_t x : sizes) most = x > most ? x : most;
  return most;
}

// Launch the dq kernel, then the dk/dv kernel, on `stream`; returns
// cudaGetLastError() (0 on success) and never synchronises.
//   kind       0 = f32 (CUDA cores), 1 = bf16 (wgmma); q, k, v, dq, dk
//              and dv share it
//   dout_kind  0 = f32 (split into bf16 hi and lo on the bf16 route), 1 =
//              bf16 (the bf16 route only)
//   q [B,Hq,N,d], k/v [B,Hk,N,d], dout [B,Hq,N,d], dq [B,Hq,N,d],
//   dk/dv [B,Hk,N,d], stats [3,B*Hq,N] f32 scratch; all contiguous and
//   16-byte aligned; d a multiple of 16 up to 128, Hq a multiple of Hk
int flash_prefill_bwd_launch(int kind, int dout_kind, const void* q,
                             const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, void* stats, int B,
                             int Hq, int Hk, int N, int d, float scale,
                             void* stream) {
  if (B <= 0 || Hk <= 0 || Hq % Hk || N <= 0 || d <= 0 || d > kMaxD ||
      d % 16 || kind < 0 || kind > 1 || dout_kind < 0 || dout_kind > 1 ||
      (kind == 0 && dout_kind != 0))
    return (int)cudaErrorInvalidValue;
  return launch_d(kind == 0 ? 0 : 1 + dout_kind, d, q, k, v, dout, dq, dk,
                  dv, stats, B, Hq, Hk, N, scale,
                  static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the largest of the latent route's kernels, in
// bytes.
size_t flash_prefill_bwd_latent_smem_bytes() {
  const size_t sizes[] = {LatDq<true>::kSmem, LatDq<false>::kSmem,
                          LatDu<true>::kSmem, LatDu<false>::kSmem};
  size_t most = 0;
  for (size_t x : sizes) most = x > most ? x : most;
  return most;
}

// The latent route (MLA: d = 576, dv = 512, V the latent's first 512
// columns, one latent "kv head"; bf16) on `stream`: an f32 dout's split,
// the dq kernel, the du kernel and the sum of its slices; returns
// cudaGetLastError() (0 on success) and never synchronises.
//   dout_kind  0 = f32 (split into bf16 hi and lo in `split`), 1 = bf16
//   q [B,Hq,N,576] and dq, the latent [B,N,576] (k, and v = its first 512
//   columns, read from its rows), dout [B,Hq,N,512], du [B,N,576] (the
//   latent's gradient through K and V) bf16; stats [3,B*Hq,N] f32
//   scratch; split [2,B,Hq,N,512] bf16 scratch (f32 dout only); part
//   [slices,B,N,576] f32 scratch: the sums of each slice of Hq / slices
//   q-heads; all contiguous and 16-byte aligned, Hq a multiple of slices
int flash_prefill_bwd_latent_launch(int dout_kind, const void* q,
                                    const void* lat, const void* dout,
                                    void* split, void* dq, void* du,
                                    void* stats, void* part, int B, int Hq,
                                    int N, int slices, float scale,
                                    void* stream) {
  if (B <= 0 || Hq <= 0 || N <= 0 || slices <= 0 || Hq % slices ||
      dout_kind < 0 || dout_kind > 1 ||
      (dout_kind == 0 && split == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dout_kind == 0)
    return launch_latent<true>(q, lat, dout, split, dq, du, stats, part, B,
                               Hq, N, slices, scale, s);
  return launch_latent<false>(q, lat, dout, split, dq, du, stats, part, B,
                              Hq, N, slices, scale, s);
}

// The latent route's f32 dout split alone: out [2, count] bf16 = hi and lo
// of x [count] f32 (count a multiple of 8, both 16-byte aligned); returns
// cudaGetLastError().
int flash_prefill_bwd_split_launch(const void* x, void* out, size_t count,
                                   void* stream) {
  if (count % 8) return (int)cudaErrorInvalidValue;
  return (int)launch_split(x, out, count, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
