// CAM-mode approximate scoring for Hopper (sm_90a), over an int8 key mirror
// or over an int4 mirror packed two codes to a byte.
//
// Replaces the TPU kernels `approx_score` and `approx_score_packed` of the
// reference package (src/repro/kernels/approx_score.py: bodies
// `_approx_score_kernel` and `_approx_score_packed_kernel`). For every row i
// of [B*Hk], query row g of its GQA group and slot s:
//   out[i][g][s] = ((qq[i][g]·kq[i][s]) * qscale[i][g]) * kscale[i][s],
// NEG_INF at invalid slots. The integer dot runs in dp4a and is exact in
// int32 (|Σ| <= 127·127·128 < 2^24, so it equals the f32 contraction of
// the plain version), and the two products are rounded in the plain
// version's order: the kernel equals it bit for bit.
//
// Packed layout: byte j of a row holds code 2j in its low nibble and code
// 2j+1 in its high nibble; a nibble >= 8 is the code - 16. A 32-bit word of
// the packed row expands to two int8x4 words before the dp4a.
//
// Design. A CTA of 256 threads scores a tile of kTile slots of one row
// (grid: rows x tiles). Eight lanes share a slot: each reads every eighth
// 4-byte word of the slot's mirror row, so a warp reads four slots' rows at
// once, and the eight partial dots meet in three shuffles. The G query rows
// are staged in shared memory as int8x4 words; G accumulators per slot.
// Invalid slots read no mirror bytes.
//
// Bound. Memory: the mirror rows of the valid slots (d bytes each, d/2
// packed), the scales and valid bytes, and the [G][S] f32 output. At the
// served shape of longchat-7b (128 rows, S = 1088, d = 128, G = 1) that is
// about 19 MB (about 10 MB packed), 5.7 us (3 us) at 3.35 TB/s; the
// 2·G·d integer operations a slot are far below the card's int8 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerSlot = 8;
constexpr int kSlotsPerPass = kThreads / kLanesPerSlot;  // 32
constexpr int kTile = 128;                               // slots per CTA
constexpr int kMaxG = 16;
constexpr int kMaxGD = 4096;  // largest G*d
constexpr float kNegInf = -1e30f;

// Sign-extended 4-bit code at bit `shift` of p.
__device__ __forceinline__ int nibble(unsigned p, int shift) {
  return ((int)((p >> shift) & 0xFu) ^ 8) - 8;
}

__device__ __forceinline__ int int8x4(int a, int b, int c, int d) {
  return (int)((unsigned)(a & 0xFF) | ((unsigned)(b & 0xFF) << 8) |
               ((unsigned)(c & 0xFF) << 16) | ((unsigned)(d & 0xFF) << 24));
}

// PACKED: kq rows are d/2 bytes of nibbles; else d bytes of int8 codes.
// MAX_G: the accumulators a thread keeps (G <= MAX_G).
template <bool PACKED, int MAX_G>
__global__ void __launch_bounds__(kThreads) approx_score_kernel(
    const int8_t* __restrict__ qq, const float* __restrict__ qscale,
    const uint8_t* __restrict__ kq, const float* __restrict__ kscale,
    const int8_t* __restrict__ valid, float* __restrict__ out, int S, int G,
    int d) {
  __shared__ int qq4[kMaxGD / 4];  // [G][d/4]

  const int row = blockIdx.x;
  const int tid = threadIdx.x, sub = tid % kLanesPerSlot;
  const int d4 = d >> 2;
  const int* qq_w = reinterpret_cast<const int*>(qq + (size_t)row * G * d);
  for (int x = tid; x < G * d4; x += kThreads) qq4[x] = qq_w[x];
  __syncthreads();

  const float* qs_row = qscale + (size_t)row * G;
  const int row_bytes = PACKED ? d / 2 : d;
  const int words = row_bytes >> 2;  // 4-byte words per mirror row
  const int s0 = blockIdx.y * kTile;
  const int s1 = min(s0 + kTile, S);
  for (int base = s0; base < s1; base += kSlotsPerPass) {
    const int s = base + tid / kLanesPerSlot;
    const bool ok = s < s1 && valid[(size_t)row * S + s] != 0;
    int acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0;
    if (ok) {
      const unsigned* kw = reinterpret_cast<const unsigned*>(
          kq + ((size_t)row * S + s) * row_bytes);
      for (int w = sub; w < words; w += kLanesPerSlot) {
        const unsigned p = kw[w];
        if (PACKED) {
          const int lo = int8x4(nibble(p, 0), nibble(p, 4), nibble(p, 8),
                                nibble(p, 12));
          const int hi = int8x4(nibble(p, 16), nibble(p, 20), nibble(p, 24),
                                nibble(p, 28));
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) {
              acc[g] = __dp4a(lo, qq4[g * d4 + 2 * w], acc[g]);
              acc[g] = __dp4a(hi, qq4[g * d4 + 2 * w + 1], acc[g]);
            }
        } else {
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) acc[g] = __dp4a((int)p, qq4[g * d4 + w], acc[g]);
        }
      }
    }
    // the eight lanes of a slot are neighbours: offsets 4, 2, 1
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G)
        for (int o = kLanesPerSlot / 2; o > 0; o >>= 1)
          acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
    if (sub == 0 && s < s1) {
      const float ks = ok ? kscale[(size_t)row * S + s] : 0.f;
      float* out_row = out + (size_t)row * G * S;
      for (int g = 0; g < G; ++g)
        out_row[(size_t)g * S + s] =
            ok ? __fmul_rn(__fmul_rn((float)acc[g], qs_row[g]), ks) : kNegInf;
    }
  }
}

template <bool PACKED, int MAX_G>
void launch(const void* qq, const void* qscale, const void* kq,
            const void* kscale, const void* valid, void* out, int BH, int S,
            int G, int d, cudaStream_t stream) {
  const dim3 grid(BH, (S + kTile - 1) / kTile);
  approx_score_kernel<PACKED, MAX_G><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(qscale),
      static_cast<const uint8_t*>(kq), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(valid), static_cast<float*>(out), S, G, d);
}

// One instantiation for G <= 8 and one for G <= kMaxG: a thread keeps
// MAX_G accumulators and walks them in unrolled loops, so G <= 8 (every
// config but starcoder2-3b's G = 12) keeps the short loops.
template <bool PACKED>
void launch_g(const void* qq, const void* qscale, const void* kq,
              const void* kscale, const void* valid, void* out, int BH,
              int S, int G, int d, cudaStream_t stream) {
  if (G <= 8)
    launch<PACKED, 8>(qq, qscale, kq, kscale, valid, out, BH, S, G, d,
                      stream);
  else
    launch<PACKED, kMaxG>(qq, qscale, kq, kscale, valid, out, BH, S, G, d,
                          stream);
}

}  // namespace

extern "C" {

// packed: 0 = int8 mirror [BH,S,d], 1 = nibble-packed [BH,S,d/2]. The
// caller guarantees d % 8 == 0 and 4-byte aligned rows; G outside
// [1, kMaxG] or G*d above kMaxGD (the shared query buffer) is refused.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// never synchronises.
int approx_score_launch(int packed, const void* qq, const void* qscale,
                        const void* kq, const void* kscale, const void* valid,
                        void* out, int BH, int S, int G, int d,
                        void* stream) {
  if (G < 1 || G > kMaxG || G * d > kMaxGD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed)
    launch_g<true>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, st);
  else
    launch_g<false>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
