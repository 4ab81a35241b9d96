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
//   dout [B, Hq, N, d]  f32     the cotangent of out (out is f32)
//   → dq [B, Hq, N, d]  T, dk and dv [B, Hk, N, d] T, each summed over the
//     g = Hq / Hk q-heads of its group; stats [3, B*Hq, N] f32 scratch.
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
// Design: deterministic, no atomics, f32 FMAs on the CUDA cores for every
// product (bf16 values are widened to f32 as they are staged). Two kernels
// on one stream, each a 16 x 16 grid of 256 threads over 64 x 64 tiles
// staged in shared memory (rows padded to d + 1 floats, so the 16 rows a
// half-warp reads for one column lie in 16 different banks):
//   bwd_dq_kernel   one CTA per (q-head, 64-row q-block), over the key
//                   tiles at or before its last row. Sweep 1 carries m, l
//                   and sum_j exp(s_ij - m) dP_ij online (the rescaling
//                   of the forward's online softmax) and gives D_i; it
//                   writes m, l, D to the stats. Sweep 2 recomputes s and
//                   dP, makes dS and adds dS k into dq in registers.
//   bwd_dkv_kernel  one CTA per (kv-head, 64-key block), after it: K and V
//                   stay in shared memory while the CTA walks the group's
//                   q-heads and, for each, the q-blocks at or after its key
//                   block; it recomputes s and dP from the stats, and adds
//                   T(P)^T dout into dv and dS^T q into dk in registers, in
//                   head order, then row-block order.
// Each output element is summed by one thread in a fixed order, so two
// launches on the same inputs give the same bits.
//
// Bound: five products of 2 B Hq (N (N + 1) / 2) d flop (q.k, dout.v,
// dS.k, dS^T.q, P^T.dout) over the causal triangle; at granite-3-2b's 4 x
// 2048 rows, 32 q-heads of d = 64, 1.719e11 flop, 0.174 ms at the 989 TF/s
// bf16 peak. This design makes nine (sweep 1 and 2 each recompute q.k and
// dout.v in the dq kernel, the dkv kernel both again) on the CUDA cores,
// whose f32 peak is 67 TF/s: it is a correct first kernel, and wgmma / TMA
// tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

namespace {

constexpr int kB = 64;            // rows of a q-block, keys of a key block
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 tile entries
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, void* stats, int B, int Hq, int Hk,
           int N, float scale, cudaStream_t stream) {
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

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* dout, void* dq, void* dk, void* dv, void* stats,
             int B, int Hq, int Hk, int N, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N, scale, s);
    case 32: return launch<T, 32>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N, scale, s);
    case 48: return launch<T, 48>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N, scale, s);
    case 64: return launch<T, 64>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N, scale, s);
    case 80: return launch<T, 80>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N, scale, s);
    case 96: return launch<T, 96>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N, scale, s);
    case 112: return launch<T, 112>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N, scale, s);
    case 128: return launch<T, 128>(q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of the larger of the two kernels at head dim d,
// in bytes (0 for a d the kernels do not take).
size_t flash_prefill_bwd_smem_bytes(int d) {
  if (d <= 0 || d > kMaxD || d % 16) return 0;
  const size_t a = dq_smem_bytes(d), b = dkv_smem_bytes(d);
  return a > b ? a : b;
}

// Launch the dq kernel, then the dk/dv kernel, on `stream`; returns
// cudaGetLastError() (0 on success) and never synchronises.
//   kind    0 = f32, 1 = bf16 (q, k, v, dq, dk, dv share it)
//   q [B,Hq,N,d], k/v [B,Hk,N,d], dout [B,Hq,N,d] f32, dq [B,Hq,N,d],
//   dk/dv [B,Hk,N,d], stats [3,B*Hq,N] f32 scratch; all contiguous;
//   d a multiple of 16 up to 128, Hq a multiple of Hk
int flash_prefill_bwd_launch(int kind, const void* q, const void* k,
                             const void* v, const void* dout, void* dq,
                             void* dk, void* dv, void* stats, int B, int Hq,
                             int Hk, int N, int d, float scale,
                             void* stream) {
  if (B <= 0 || Hk <= 0 || Hq % Hk || N <= 0 || d <= 0 || d > kMaxD ||
      d % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return launch_d<float>(d, q, k, v, dout, dq, dk, dv, stats, B, Hq, Hk, N,
                           scale, s);
  if (kind == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, dout, dq, dk, dv, stats, B, Hq,
                                   Hk, N, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
