// Fill-aware fused pruned decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `ragged_decode` of the reference package
// (src/repro/kernels/ragged_decode.py: wrapper `ragged_decode`, body
// `_ragged_decode_kernel`). Per row i of [B*Hk] it computes, in one pass:
//   1. CAM scoring over the live mirror blocks only:
//        score[g][s] = (qq[g]·mirror[s]) * qscale[g] * mscale[s]
//      for s < ceil(min(fill, S) / block_s) * block_s, NEG_INF at invalid
//      and dead slots (dp4a on the int8 codes: exact in int32);
//   2. the global top-k race: ssel[s] = Σ_g score[g][s] in row order,
//      protected slots get PROT_WIN, then select_k rounds of block-wide
//      argmax (first max wins; each pick is marked PICKED);
//   3. the winner gather: only the winners' K/V rows are read, times
//      kscale / vscale (K and V are f32, bf16 or int8: a template);
//   4. exact softmax attention over the winners → out [G][dv];
//   5. the charge-domain probabilities probs[s] = Σ_g softmax_g(score/√d),
//      exactly 0 at dead and invalid slots.
//
// Design. One CTA of 256 threads per row; it reads its own fill (no scalar
// prefetch). The TPU walks slot blocks in grid order and carries a VMEM
// score buffer between steps; here the loop over live slots runs inside the
// CTA and the [G][S] f32 score buffer lives in shared memory, so scores,
// indices and winners never touch device memory. A row with fill == 0
// scores nothing, picks only invalid slots and writes out = 0, probs = 0.
//
// Bound. Memory: per row the kernel must read the live mirror rows
// (fill x d bytes), their scales and valid bytes, the protection mask, and
// the winners' K/V rows and scales, and write probs [S] and out [G][dv].
// At the served decode shape of longchat-7b (128 rows = 4 lanes x 32 heads,
// S = 1088, fills 690..1050, d = 128, select_k = 128) that is 25.6 MB per
// launch with bf16 K/V (21.4 MB int8): 7.6 us (6.4 us) at 3.35 TB/s, as
// chip_smoke.py reckons it from its inputs. The integer scoring
// (2·G·d·fill ops a row) and the f32 attention are far below the card's
// rates. This first kernel is correct and simple, not fast: one CTA per
// row, a warp per slot or winner with little memory-level parallelism, and
// a race of select_k rounds of block-wide argmax, two barriers each; its
// measured time, tens of times the bound, is in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;
constexpr float kProtWin = 1e30f;
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
__device__ float block_reduce(float v, float* red, bool is_max) {
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

template <typename KV>
__global__ void __launch_bounds__(kThreads) ragged_decode_kernel(
    const int* __restrict__ fills, const float* __restrict__ q,
    const int8_t* __restrict__ qq, const float* __restrict__ qscale,
    const int8_t* __restrict__ mirror, const float* __restrict__ mscale,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int8_t* __restrict__ valid, const int8_t* __restrict__ prot,
    const KV* __restrict__ k, const KV* __restrict__ v,
    float* __restrict__ out, float* __restrict__ probs, int S, int G, int d,
    int dv, int select_k, int block_s, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* score = reinterpret_cast<float*>(smem_raw);  // [G][S]
  float* ssel = score + G * S;                          // [S]
  float* qf = ssel + S;                                 // [G][d]
  float* plog = qf + G * d;                             // [G][select_k]
  float* red = plog + G * select_k;                     // [kWarps]
  float* red_v = red + kWarps;                          // [kWarps]
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);  // [kWarps]
  int* picks = red_i + kWarps;                          // [select_k]
  int* qq4 = picks + select_k;                          // [G][d/4]

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = d >> 2;
  const int fill = min(max(fills[row], 0), S);
  const int live = min((fill + block_s - 1) / block_s * block_s, S);

  const int8_t* valid_row = valid + (size_t)row * S;
  const float* qs_row = qscale + (size_t)row * G;

  // -- stage the queries; dead slots start at NEG_INF ----------------------
  for (int x = tid; x < G * d; x += kThreads) qf[x] = q[(size_t)row * G * d + x];
  const int* qq_row = reinterpret_cast<const int*>(qq + (size_t)row * G * d);
  for (int x = tid; x < G * d4; x += kThreads) qq4[x] = qq_row[x];
  for (int x = tid; x < G * S; x += kThreads)
    if (x % S >= live) score[x] = kNegInf;
  __syncthreads();

  // -- 1. CAM scoring over the live blocks: one warp per slot --------------
  const int8_t* mir_row = mirror + (size_t)row * S * d;
  const float* ms_row = mscale + (size_t)row * S;
  for (int s = warp; s < live; s += kWarps) {
    int acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0;
    const int* m4 = reinterpret_cast<const int*>(mir_row + (size_t)s * d);
    for (int w = lane; w < d4; w += 32) {
      const int m = m4[w];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = __dp4a(m, qq4[g * d4 + w], acc[g]);
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
          score[g * S + s] =
              ok ? __fmul_rn(__fmul_rn((float)acc[g], qs_row[g]), ms) : kNegInf;
    }
  }
  __syncthreads();

  // -- 2. the race: G-row sum, protected slots win, select_k argmax rounds --
  const int8_t* prot_row = prot + (size_t)row * S;
  for (int s = tid; s < S; s += kThreads) {
    float t = score[s];
    for (int g = 1; g < G; ++g) t = __fadd_rn(t, score[g * S + s]);
    ssel[s] = prot_row[s] != 0 ? kProtWin : t;
  }
  __syncthreads();

  // each thread keeps the best of the slots it owns (s ≡ tid mod kThreads);
  // after a pick only the owner of the picked slot rescans
  float bv = -INFINITY;
  int bi = INT_MAX;
  auto rescan = [&]() {
    bv = -INFINITY;
    bi = INT_MAX;
    for (int s = tid; s < S; s += kThreads)
      if (beats(ssel[s], s, bv, bi)) {
        bv = ssel[s];
        bi = s;
      }
  };
  rescan();
  for (int r = 0; r < select_k; ++r) {
    float cv = bv;
    int ci = bi;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, cv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, ci, o);
      if (beats(ov, oi, cv, ci)) {
        cv = ov;
        ci = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = cv;
      red_i[warp] = ci;
    }
    __syncthreads();
    if (warp == 0) {
      cv = lane < kWarps ? red_v[lane] : -INFINITY;
      ci = lane < kWarps ? red_i[lane] : INT_MAX;
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, cv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, ci, o);
        if (beats(ov, oi, cv, ci)) {
          cv = ov;
          ci = oi;
        }
      }
      if (lane == 0) {
        picks[r] = ci;
        ssel[ci] = kPicked;
      }
    }
    __syncthreads();
    if (picks[r] % kThreads == tid) rescan();
  }

  // -- 3+4. winners' logits: one warp per winner; invalid picks masked -----
  const KV* k_row = k + (size_t)row * S * d;
  const KV* v_row = v + (size_t)row * S * dv;
  const float* ks_row = kscale + (size_t)row * S;
  const float* vs_row = vscale + (size_t)row * S;
  for (int j = warp; j < select_k; j += kWarps) {
    const int p = picks[j];
    if (valid_row[p] == 0) {
      if (lane == 0)
        for (int g = 0; g < G; ++g) plog[g * select_k + j] = kNegInf;
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
        if (g < G) acc[g] += qf[g * d + c] * kv;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] = warp_sum(acc[g]);
    if (lane == 0)
      for (int g = 0; g < G; ++g)
        plog[g * select_k + j] = __fmul_rn(acc[g], scale);
  }
  __syncthreads();

  // masked softmax over the winners, one group row at a time
  for (int g = 0; g < G; ++g) {
    float* pl = plog + g * select_k;
    float m = -INFINITY;
    for (int j = tid; j < select_k; j += kThreads) m = fmaxf(m, pl[j]);
    m = block_reduce(m, red, true);
    float z = 0.f;
    for (int j = tid; j < select_k; j += kThreads) {
      const float l = pl[j];
      const float e = l > 0.5f * kNegInf ? expf(l - m) : 0.f;
      pl[j] = e;
      z += e;
    }
    z = fmaxf(block_reduce(z, red, false), 1e-30f);
    for (int j = tid; j < select_k; j += kThreads) pl[j] = pl[j] / z;
  }
  __syncthreads();

  float* out_row = out + (size_t)row * G * dv;
  for (int x = tid; x < G * dv; x += kThreads) {
    const int g = x / dv, c = x - g * dv;
    const float* pl = plog + g * select_k;
    float acc = 0.f;
    for (int j = 0; j < select_k; ++j) {
      const float p = pl[j];
      if (p != 0.f) {
        const int s = picks[j];
        acc += p * __fmul_rn(to_f32(v_row[(size_t)s * dv + c]), vs_row[s]);
      }
    }
    out_row[x] = acc;
  }

  // -- 5. charge-domain probabilities from the score buffer -----------------
  float mg[kMaxG], zg[kMaxG];
  for (int g = 0; g < G; ++g) {
    const float* sc = score + g * S;
    float m = -INFINITY;
    for (int s = tid; s < S; s += kThreads) m = fmaxf(m, __fmul_rn(sc[s], scale));
    m = block_reduce(m, red, true);
    float z = 0.f;
    for (int s = tid; s < S; s += kThreads) {
      const float x = sc[s];
      if (x > 0.5f * kNegInf) z += expf(__fmul_rn(x, scale) - m);
    }
    mg[g] = m;
    zg[g] = fmaxf(block_reduce(z, red, false), 1e-30f);
  }
  float* probs_row = probs + (size_t)row * S;
  for (int s = tid; s < S; s += kThreads) {
    float p = 0.f;
    for (int g = 0; g < G; ++g) {
      const float x = score[g * S + s];
      if (x > 0.5f * kNegInf) p += expf(__fmul_rn(x, scale) - mg[g]) / zg[g];
    }
    probs_row[s] = p;
  }
}

template <typename KV>
int launch(const void* fills, const void* q, const void* qq, const void* qscale,
           const void* mirror, const void* mscale, const void* kscale,
           const void* vscale, const void* valid, const void* prot,
           const void* k, const void* v, void* out, void* probs, int BH,
           int S, int G, int d, int dv, int select_k, int block_s,
           float scale, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_decode_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ragged_decode_kernel<KV><<<BH, kThreads, smem, stream>>>(
      static_cast<const int*>(fills), static_cast<const float*>(q),
      static_cast<const int8_t*>(qq), static_cast<const float*>(qscale),
      static_cast<const int8_t*>(mirror), static_cast<const float*>(mscale),
      static_cast<const float*>(kscale), static_cast<const float*>(vscale),
      static_cast<const int8_t*>(valid), static_cast<const int8_t*>(prot),
      static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<float*>(out), static_cast<float*>(probs), S, G, d, dv,
      select_k, block_s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes.
size_t ragged_decode_smem_bytes(int S, int G, int d, int select_k) {
  return sizeof(float) * ((size_t)G * S + S + (size_t)G * d +
                          (size_t)G * select_k + 2 * kWarps) +
         sizeof(int) * (kWarps + (size_t)select_k) + (size_t)G * d;
}

int ragged_decode_max_groups() { return kMaxG; }

// kv_kind: 0 = f32, 1 = bf16, 2 = int8 K/V. Launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
int ragged_decode_launch(int kv_kind, const void* fills, const void* q,
                         const void* qq, const void* qscale,
                         const void* mirror, const void* mscale,
                         const void* kscale, const void* vscale,
                         const void* valid, const void* prot, const void* k,
                         const void* v, void* out, void* probs, int BH, int S,
                         int G, int d, int dv, int select_k, int block_s,
                         float scale, void* stream) {
  const size_t smem = ragged_decode_smem_bytes(S, G, d, select_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case 0:
      return launch<float>(fills, q, qq, qscale, mirror, mscale, kscale,
                           vscale, valid, prot, k, v, out, probs, BH, S, G, d,
                           dv, select_k, block_s, scale, smem, st);
    case 1:
      return launch<__nv_bfloat16>(fills, q, qq, qscale, mirror, mscale,
                                   kscale, vscale, valid, prot, k, v, out,
                                   probs, BH, S, G, d, dv, select_k, block_s,
                                   scale, smem, st);
    case 2:
      return launch<int8_t>(fills, q, qq, qscale, mirror, mscale, kscale,
                            vscale, valid, prot, k, v, out, probs, BH, S, G, d,
                            dv, select_k, block_s, scale, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
