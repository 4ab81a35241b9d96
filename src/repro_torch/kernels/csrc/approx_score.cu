// CAM-mode approximate scoring for Hopper (sm_90a), over an int8 key mirror
// or over an int4 mirror packed two codes to a byte.
//
// Replaces the TPU kernels `approx_score` and `approx_score_packed` of the
// reference package (src/repro/kernels/approx_score.py: bodies
// `_approx_score_kernel` and `_approx_score_packed_kernel`). For every row i
// of [B*Hk], query row g of its GQA group and slot s:
//   out[i][g][s] = ((qq[i][g]·kq[i][s]) * qscale[i][g]) * kscale[i][s],
// NEG_INF at invalid slots. The integer dot is exact in int32 (|Σ| <=
// 127·127·128 < 2^24, so it equals the f32 contraction of the plain
// version), and the two products are rounded in the plain version's order:
// the kernel equals it bit for bit.
//
// Bound. Memory: the mirror rows of the valid slots (d bytes each, d/2
// packed), the scales and valid bytes, and the [G][S] f32 output. At the
// served shape of longchat-7b (128 rows, S = 1088, d = 128, G = 1, the
// served fills) that is 16.8 MB (9.0 MB packed), 5.0 us (2.7 us) at
// 3.35 TB/s; the 2·G·d integer operations a slot are far below the card's
// int8 rate.
//
// The int8 mirror (approx_score_mma_kernel). The old design, one CTA a
// 128-slot tile with 8 lanes a slot and dp4a, kept one 4-byte load a lane
// in flight behind a chain (valid, then mirror, then shuffles, then
// kscale), read the query from shared memory for every dp4a and stored
// from one lane in eight: 3.2x the bound. Here:
//   - Persistent CTAs, two an SM, walk an even share of the (row, 32-slot
//     tile) items, a warp one item at a time; the next item's valid bytes
//     are in flight while this one is scored.
//   - The products run on the tensor cores, mma.sync m16n8k32 s8 x s8 ->
//     s32 (exact): A is the G query rows padded with zero rows to 16, B is
//     8 slots x 32 mirror bytes, four n-blocks an item. The mirror goes
//     straight from device memory into the B fragments, 16 bytes a lane (8
//     or 4 where d or the pointer allow no more): a lane's bytes are
//     contiguous, and the query's words are read at the same offsets, so
//     A and B share one permutation of k and the sum is unchanged. Bytes
//     past d (d = 112, or any d % 32 != 0) are neither read nor counted:
//     their query and mirror words are zero. Chunks of 128 bytes of d
//     (four k-steps) keep the fragments in registers at any d.
//   - An invalid slot's row is not read (each lane's load is predicated
//     on its slot), so the bytes read are the bound's: none are added at
//     the served fills. A tile with no valid slot reads no mirror byte and
//     writes NEG_INF.
//   - valid and kscale are read as vectors once a tile; the accumulators
//     meet in a [16][32] tile of the warp's shared memory, and each lane
//     stores four consecutive slots of a row g as one 16-byte store.
// No shared-memory stage or ldmatrix: the B fragments' 16-byte loads are
// the stage (16 warps an SM keep 64 KB in flight), and a 1-D bulk copy of
// contiguous rows would need padding or a swizzle before ldmatrix could
// read it without bank conflicts.
//
// The packed mirror (approx_score_kernel<MAX_G>, the earlier design). A CTA of
// 256 threads scores a tile of kTile slots of one row (grid: rows x
// tiles). Eight lanes share a slot: each reads every eighth 4-byte word of
// the slot's packed row, expands it to two int8x4 words (byte j of a row
// holds code 2j in its low nibble and code 2j+1 in its high nibble; a
// nibble >= 8 is the code - 16) and runs dp4a; the eight partial dots meet
// in three shuffles. The G query rows are staged in shared memory as
// int8x4 words. Invalid slots read no mirror bytes.

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

// kq rows are d/2 bytes of nibbles. MAX_G: the accumulators a thread keeps
// (G <= MAX_G).
template <int MAX_G>
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
  const int row_bytes = d / 2;
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

template <int MAX_G>
void launch(const void* qq, const void* qscale, const void* kq,
            const void* kscale, const void* valid, void* out, int BH, int S,
            int G, int d, cudaStream_t stream) {
  const dim3 grid(BH, (S + kTile - 1) / kTile);
  approx_score_kernel<MAX_G><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(qscale),
      static_cast<const uint8_t*>(kq), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(valid), static_cast<float*>(out), S, G, d);
}

// One instantiation for G <= 8 and one for G <= kMaxG: a thread keeps
// MAX_G accumulators and walks them in unrolled loops, so G <= 8 (every
// config but starcoder2-3b's G = 12) keeps the short loops.
void launch_packed(const void* qq, const void* qscale, const void* kq,
                   const void* kscale, const void* valid, void* out, int BH,
                   int S, int G, int d, cudaStream_t stream) {
  if (G <= 8)
    launch<8>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, stream);
  else
    launch<kMaxG>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, stream);
}

// ---------------------------------------------------------------------------
// the int8 mirror on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kItemSlots = 32;  // slots a warp scores at once: 4 n-blocks
constexpr int kChunk = 128;     // bytes of d a k-chunk: four k-steps
constexpr int kXStride = 40;    // words between rows g of the exchange tile
constexpr int kCtasPerSm = 2;

// c += a · b over one m16n8k32 tile, s8 x s8 -> s32 (exact).
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte offset in a k-chunk of word m (0..7) of the lanes whose
// threadID_in_group is `tig`, when a slot's row is read VEC bytes a load
// and its four lanes read consecutive pieces. Words 2ks and 2ks + 1 are
// the lane's B registers of k-step ks, and the query's words at the same
// offsets its A registers: one permutation of k for both.
template <int VEC>
__device__ __forceinline__ int word_offset(int m, int tig) {
  constexpr int W = VEC / 4;  // words a load
  return ((m / W) * 4 + tig) * VEC + 4 * (m % W);
}

template <int VEC>
__device__ __forceinline__ void load_words(const int8_t* p, int* w) {
  if constexpr (VEC == 16) {
    const int4 x = *reinterpret_cast<const int4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (VEC == 8) {
    const int2 x = *reinterpret_cast<const int2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const int*>(p);
  }
}

// Four floats at p[s..s+3] of a row of S: one 16-byte access when `vec`
// (S % 4 == 0, 16-byte aligned rows) and all four lie below S.
__device__ __forceinline__ void load4(const float* p, int s, int S, bool vec,
                                      float (&o)[4]) {
  if (vec && s + 3 < S) {
    const float4 x = *reinterpret_cast<const float4*>(p + s);
    o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = s + i < S ? p[s + i] : 0.f;
  }
}
__device__ __forceinline__ void store4(float* p, int s, int S, bool vec,
                                       const float (&o)[4]) {
  if (vec && s + 3 < S) {
    *reinterpret_cast<float4*>(p + s) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (s + i < S) p[s + i] = o[i];
  }
}

// VEC: bytes a mirror load (16, or 8 / 4 where d or the pointer allow no
// more). vec_out: S % 4 == 0 and kscale, out 16-byte aligned.
template <int VEC>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    approx_score_mma_kernel(const int8_t* __restrict__ qq,
                            const float* __restrict__ qscale,
                            const int8_t* __restrict__ kq,
                            const float* __restrict__ kscale,
                            const int8_t* __restrict__ valid,
                            float* __restrict__ out, int BH, int S, int G,
                            int d, int vec_out) {
  constexpr int W = VEC / 4;
  __shared__ __align__(16) int xch[kWarps][16 * kXStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // fragment coordinates
  const int q4 = lane & 7;  // the epilogue's slots: 4 * q4 .. 4 * q4 + 3
  // items (rows x tiles) < 2^31: 2^31 items are 2^36 slots of at least 8
  // bytes, a mirror no card holds (the launcher refuses more)
  const int tiles = (S + kItemSlots - 1) / kItemSlots;
  const long long items = (long long)BH * tiles;
  const int lo = (int)(items * blockIdx.x / gridDim.x);
  const int hi = (int)(items * (blockIdx.x + 1) / gridDim.x);
  const int nchunks = (d + kChunk - 1) / kChunk;
  int* x = xch[warp];

  // item `it`: slot s0 + lane of its row valid?
  auto lane_valid = [&](int it) {
    const int row = (int)(it / tiles);
    const int s = (int)(it % tiles) * kItemSlots + lane;
    return s < S && valid[(size_t)row * S + s] != 0;
  };
  int it = lo + warp;
  bool ok_next = it < hi && lane_valid(it);
  for (; it < hi; it += kWarps) {
    const bool ok = ok_next;
    if (it + kWarps < hi) ok_next = lane_valid(it + kWarps);
    const int row = (int)(it / tiles);
    const int s0 = (int)(it % tiles) * kItemSlots;
    const size_t rs = (size_t)row * S;
    float* out_row = out + rs * G;
    const int se = s0 + 4 * q4;
    const unsigned vm = __ballot_sync(0xffffffffu, ok);
    if (vm == 0) {  // no valid slot: no mirror byte read
      const float neg[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
      for (int g = lane >> 3; g < G; g += 4)
        store4(out_row + (size_t)g * S, se, S, vec_out, neg);
      continue;
    }
    float ks[4], qs[4];
    load4(kscale + rs, se, S, vec_out, ks);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = (lane >> 3) + 4 * r;
      qs[r] = g < G ? qscale[(size_t)row * G + g] : 0.f;
    }

    int acc[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nb][i] = 0;
    const int8_t* qa = qq + ((size_t)row * G + gid) * d;  // A row gid
    const int8_t* qb = qa + (size_t)8 * d;                // A row gid + 8
    for (int kc = 0; kc < nchunks; ++kc) {
      const int k0 = kc * kChunk;
      int a[8][2], b[4][8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int off = k0 + word_offset<VEC>(m, tig);
        a[m][0] = off < d && gid < G ? *reinterpret_cast<const int*>(qa + off)
                                     : 0;
        a[m][1] = off < d && gid + 8 < G
                      ? *reinterpret_cast<const int*>(qb + off)
                      : 0;
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const bool live = (vm >> (nb * 8 + gid)) & 1u;
        const int8_t* src = kq + (rs + s0 + nb * 8 + gid) * d + k0;
#pragma unroll
        for (int t = 0; t < 8 / W; ++t) {
          const int off = (t * 4 + tig) * VEC;
          if (live && k0 + off < d) {
            load_words<VEC>(src + off, &b[nb][t * W]);
          } else {
#pragma unroll
            for (int e = 0; e < W; ++e) b[nb][t * W + e] = 0;
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int ks_ = 0; ks_ < 4; ++ks_)
          mma_s8(acc[nb], a[2 * ks_][0], a[2 * ks_][1], a[2 * ks_ + 1][0],
                 a[2 * ks_ + 1][1], b[nb][2 * ks_], b[nb][2 * ks_ + 1]);
    }

    // the accumulators (g = gid / gid + 8, slots nb * 8 + 2 tig, + 1) meet
    // in the warp's tile; each lane then writes four slots of a row g
    __syncwarp();  // the previous item's readers are done with x
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int c = nb * 8 + 2 * tig;
      if (gid < G)
        *reinterpret_cast<int2*>(x + gid * kXStride + c) =
            make_int2(acc[nb][0], acc[nb][1]);
      if (gid + 8 < G)
        *reinterpret_cast<int2*>(x + (gid + 8) * kXStride + c) =
            make_int2(acc[nb][2], acc[nb][3]);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = (lane >> 3) + 4 * r;
      if (g < G) {
        const int4 w = *reinterpret_cast<const int4*>(x + g * kXStride +
                                                      4 * q4);
        const int wi[4] = {w.x, w.y, w.z, w.w};
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[i] = (vm >> (4 * q4 + i)) & 1u
                     ? __fmul_rn(__fmul_rn((float)wi[i], qs[r]), ks[i])
                     : kNegInf;
        store4(out_row + (size_t)g * S, se, S, vec_out, o);
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      n = 132;
  }
  return n;
}

template <int VEC>
void launch_mma(const void* qq, const void* qscale, const void* kq,
                const void* kscale, const void* valid, void* out, int BH,
                int S, int G, int d, cudaStream_t stream) {
  const long long items =
      (long long)BH * ((S + kItemSlots - 1) / kItemSlots);
  if (items == 0) return;
  const long long want = (items + kWarps - 1) / kWarps;
  const int grid = (int)(want < (long long)kCtasPerSm * sm_count()
                             ? want
                             : (long long)kCtasPerSm * sm_count());
  const int vec_out = S % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(kscale) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  approx_score_mma_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(qscale),
      static_cast<const int8_t*>(kq), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(valid), static_cast<float*>(out), BH, S, G,
      d, vec_out);
}

// The widest mirror load that tiles d and the pointer's alignment allows.
void launch_int8(const void* qq, const void* qscale, const void* kq,
                 const void* kscale, const void* valid, void* out, int BH,
                 int S, int G, int d, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(kq);
  if (d % 16 == 0 && a % 16 == 0)
    launch_mma<16>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, stream);
  else if (a % 8 == 0)
    launch_mma<8>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, stream);
  else
    launch_mma<4>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, stream);
}

}  // namespace

extern "C" {


// packed: 0 = int8 mirror [BH,S,d] (the tensor-core kernel), 1 =
// nibble-packed [BH,S,d/2] (the dp4a template). The caller guarantees
// d % 8 == 0 and 4-byte aligned rows; G outside [1, kMaxG] or G*d above
// kMaxGD (the packed kernel's shared query buffer) is refused for both.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// never synchronises.
int approx_score_launch(int packed, const void* qq, const void* qscale,
                        const void* kq, const void* kscale, const void* valid,
                        void* out, int BH, int S, int G, int d,
                        void* stream) {
  if (G < 1 || G > kMaxG || G * d > kMaxGD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed) {
    launch_packed(qq, qscale, kq, kscale, valid, out, BH, S, G, d, st);
  } else {
    if ((long long)BH * ((S + kItemSlots - 1) / kItemSlots) > 2147483647LL)
      return (int)cudaErrorInvalidValue;  // no card holds such a mirror
    launch_int8(qq, qscale, kq, kscale, valid, out, BH, S, G, d, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
