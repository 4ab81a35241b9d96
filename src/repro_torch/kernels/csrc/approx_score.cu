// CAM-mode approximate scoring for Hopper (sm_90a), over an int8 key mirror
// or over an int4 mirror packed two codes to a byte.
//
// Replaces the TPU kernels `approx_score` and `approx_score_packed` of the
// reference package (src/repro/kernels/approx_score.py: bodies
// `_approx_score_kernel` and `_approx_score_packed_kernel`). For every row i
// of [B*Hk], query row g of its GQA group and slot s:
//   out[i][g][s] = ((qq[i][g]·kq[i][s]) * qscale[i][g]) * kscale[i][s],
// NEG_INF at invalid slots. The integer dot is exact in int32, and its one
// conversion to f32 is exact while |Σ| < 2^24: over the packed mirror
// (codes in [-8, 7]) at every accepted shape, |Σ| <= 128·8·4096 = 2^22;
// over the int8 mirror up to d = 1040 (1040·127² < 2^24; core/scoring.py's
// EXACT_MAX_D), where the plain version's f32 contraction is exact too.
// The two products are rounded in the plain version's order, so the kernel
// equals it bit for bit there.
//
// Bound. Memory: the mirror rows of the valid slots (d bytes each, d/2
// packed), the scales and valid bytes, and the [G][S] f32 output. At the
// served shape of longchat-7b (128 rows, S = 1088, d = 128, G = 1, the
// served fills) that is 16.8 MB (9.0 MB packed), 5.0 us (2.7 us) at
// 3.35 TB/s; the 2·G·d integer operations a slot are far below the card's
// int8 rate.
//
// One design, approx_score_mma_kernel<VEC, PACKED>, with two B loaders:
//   - Persistent CTAs of four warps walk an even share of the (row,
//     32-slot tile) items, a warp one item at a time; the next item's
//     valid bytes are in flight while this one is scored, and its (row,
//     tile) is stepped without a division. Each item waits for its
//     operands' round trip, so fewer items a warp shorten the run: four
//     CTAs an SM over the int8 mirror (16 warps, at most 128 registers),
//     five over the packed one (20 warps, at most 102), so at longchat-7b's
//     served shape a warp walks at most 3 and 2 items.
//   - The products run on the tensor cores, mma.sync m16n8k32 s8 x s8 ->
//     s32 (exact): A is the G query rows padded with zero rows to 16, B is
//     8 slots x 32 codes, four n-blocks an item. Chunks of 128 codes of d
//     (four k-steps) keep the fragments in registers at any d.
//   - The mirror goes straight from device memory into the B fragments,
//     VEC bytes a load (16, or 8 / 4 where the row's bytes or the pointer
//     allow no more): a lane's bytes are contiguous, and the four lanes
//     of a slot read consecutive pieces (word_offset). An int8 chunk is
//     128 bytes a slot, two 16-byte loads a lane; a packed one is 64
//     bytes, one 16-byte load a lane.
//   - Packed words are expanded in registers, in a k order that A
//     shares. Byte j of a packed row holds code 2j in its low nibble and
//     code 2j+1 in its high nibble (a nibble >= 8 is the code - 16). Of a
//     packed word p (codes c..c+7), (p << 4) & 0xF0F0F0F0 holds the even
//     codes c, c+2, c+4, c+6 and p & 0xF0F0F0F0 the odd ones, each in the
//     high nibble of its byte: as an s8 that byte is exactly 16·code. The
//     matching A words are prmt(q0, q1, 0x6420) and prmt(q0, q1, 0x7531)
//     of the query's two words at codes c..c+7. The sum is 16·Σ, exact in
//     s32 (|16·Σ| <= 2^26), and the epilogue shifts it right by 4.
//   - The query's words are read at the mirror's offsets, so A and B share
//     one permutation of k and the sum is unchanged. Codes past d (d = 112
//     or 40, or any d % 128 != 0) are neither read nor counted: their
//     query and mirror words are zero.
//   - An invalid slot's row is not read (each lane's load is predicated
//     on its slot), so the bytes read are the bound's: none are added at
//     the served fills. A tile with no valid slot reads no mirror byte and
//     writes NEG_INF.
//   - valid and kscale are read as vectors once a tile; the accumulators
//     meet in a [16][32] tile of the warp's shared memory, and each lane
//     stores four consecutive slots of a row g as one 16-byte store.
// No shared-memory stage or ldmatrix: the B fragments' 16-byte loads are
// the stage (16 warps an SM keep 64 KB in flight over the int8 mirror),
// and a 1-D bulk copy of contiguous rows would need padding or a swizzle
// before ldmatrix could read it without bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxGD = 4096;    // largest G*d the launcher accepts
constexpr float kNegInf = -1e30f;
constexpr int kItemSlots = 32;  // slots a warp scores at once: 4 n-blocks
constexpr int kChunk = 128;     // codes of d a k-chunk: four k-steps
constexpr int kXStride = 40;    // words between rows g of the exchange tile
// CTAs an SM: 16 warps over the int8 mirror (at most 128 registers a
// thread), 20 over the packed one (at most 102), whose half-size mirror
// words leave room for more warps and so fewer items a warp
template <bool PACKED>
constexpr int ctas_per_sm() { return PACKED ? 5 : 4; }

// c += a · b over one m16n8k32 tile, s8 x s8 -> s32 (exact).
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte offset in a chunk of a mirror row (128 int8 bytes, or 64 packed) of
// mirror word m of the lanes whose threadID_in_group is `tig`, when a
// slot's row is read VEC bytes a load and its four lanes read consecutive
// pieces: m = t * (VEC / 4) + e is word e of load t.
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

__device__ __forceinline__ int word_at(const int8_t* p) {
  return *reinterpret_cast<const int*>(p);
}

// The eight A words of one query row (`row`: a real row, not padding) for
// the chunk at code k0. Words 2ks and 2ks + 1 feed k-step ks. Int8: the
// query's word at mirror word m's offset. Packed: packed word m (codes
// 2·off .. 2·off + 7) gives A words 2m (its even codes) and 2m + 1 (odd).
template <int VEC, bool PACKED>
__device__ __forceinline__ void load_a(const int8_t* q, int k0, int d,
                                       bool row, int tig, int (&a)[8]) {
  if constexpr (PACKED) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int off = k0 + 2 * word_offset<VEC>(m, tig);
      const bool in = row && off < d;
      const int q0 = in ? word_at(q + off) : 0;
      const int q1 = in ? word_at(q + off + 4) : 0;
      a[2 * m] = (int)__byte_perm(q0, q1, 0x6420);
      a[2 * m + 1] = (int)__byte_perm(q0, q1, 0x7531);
    }
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int off = k0 + word_offset<VEC>(m, tig);
      a[m] = row && off < d ? word_at(q + off) : 0;
    }
  }
}

// The eight B words of one slot's mirror row `src` (rb bytes) for the
// chunk at byte kb of the row, in load_a's k order; zeros where the slot
// is not `live` or past the row. Packed: 16·code in every byte.
template <int VEC, bool PACKED>
__device__ __forceinline__ void load_b(const int8_t* src, int kb, int rb,
                                       bool live, int tig, int (&b)[8]) {
  constexpr int W = VEC / 4;
  constexpr int kWords = PACKED ? 4 : 8;  // mirror words a lane reads
  int r[kWords];
#pragma unroll
  for (int t = 0; t < kWords / W; ++t) {
    const int off = kb + (t * 4 + tig) * VEC;
    if (live && off < rb) {
      load_words<VEC>(src + off, &r[t * W]);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) r[t * W + e] = 0;
    }
  }
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    if constexpr (PACKED) {
      b[2 * m] = (int)(((unsigned)r[m] << 4) & 0xF0F0F0F0u);
      b[2 * m + 1] = (int)((unsigned)r[m] & 0xF0F0F0F0u);
    } else {
      b[m] = r[m];
    }
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

// VEC: bytes a mirror load (16, or 8 / 4 where the row or the pointer allow
// no more). PACKED: kq rows are d/2 bytes of nibbles, else d int8 codes.
// vec_out: S % 4 == 0 and kscale, out 16-byte aligned.
template <int VEC, bool PACKED>
__global__ void __launch_bounds__(kThreads, ctas_per_sm<PACKED>())
    approx_score_mma_kernel(const int8_t* __restrict__ qq,
                            const float* __restrict__ qscale,
                            const int8_t* __restrict__ kq,
                            const float* __restrict__ kscale,
                            const int8_t* __restrict__ valid,
                            float* __restrict__ out, int BH, int S, int G,
                            int d, int vec_out) {
  __shared__ __align__(16) int xch[kWarps][16 * kXStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // fragment coordinates
  const int q4 = lane & 7;  // the epilogue's slots: 4 * q4 .. 4 * q4 + 3
  // items (rows x tiles) < 2^31: 2^31 items are 2^36 slots of at least 4
  // bytes, a mirror no card holds (the launcher refuses more)
  const int tiles = (S + kItemSlots - 1) / kItemSlots;
  const long long items = (long long)BH * tiles;
  const int lo = (int)(items * blockIdx.x / gridDim.x);
  const int hi = (int)(items * (blockIdx.x + 1) / gridDim.x);
  const int nchunks = (d + kChunk - 1) / kChunk;
  const int rb = PACKED ? d / 2 : d;  // bytes of a mirror row
  int* x = xch[warp];

  // the warp's items lo + warp + i * kWarps as (row, tile), advanced
  // without a division
  auto advance = [&](int& r, int& t) {
    t += kWarps;
    while (t >= tiles) t -= tiles, ++r;
  };
  auto lane_valid = [&](int r, int t) {
    const int s = t * kItemSlots + lane;
    return s < S && valid[(size_t)r * S + s] != 0;
  };
  int it = lo + warp;
  int row = it / tiles, tile = it % tiles, nrow = row, ntile = tile;
  advance(nrow, ntile);
  bool ok_next = it < hi && lane_valid(row, tile);
  for (; it < hi;
       it += kWarps, row = nrow, tile = ntile, advance(nrow, ntile)) {
    const bool ok = ok_next;
    if (it + kWarps < hi) ok_next = lane_valid(nrow, ntile);
    const int s0 = tile * kItemSlots;
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
      int a[2][8], b[4][8];
      load_a<VEC, PACKED>(qa, k0, d, gid < G, tig, a[0]);
      load_a<VEC, PACKED>(qb, k0, d, gid + 8 < G, tig, a[1]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        load_b<VEC, PACKED>(kq + (rs + s0 + nb * 8 + gid) * rb,
                            PACKED ? k0 / 2 : k0, rb,
                            (vm >> (nb * 8 + gid)) & 1u, tig, b[nb]);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int ks_ = 0; ks_ < 4; ++ks_)
          mma_s8(acc[nb], a[0][2 * ks_], a[1][2 * ks_], a[0][2 * ks_ + 1],
                 a[1][2 * ks_ + 1], b[nb][2 * ks_], b[nb][2 * ks_ + 1]);
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
        // packed: 16·Σ, a multiple of 16, so the shift is exact
        const int sh = PACKED ? 4 : 0;
        const int wi[4] = {w.x >> sh, w.y >> sh, w.z >> sh, w.w >> sh};
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

template <int VEC, bool PACKED>
void launch_mma(const void* qq, const void* qscale, const void* kq,
                const void* kscale, const void* valid, void* out, int BH,
                int S, int G, int d, cudaStream_t stream) {
  const long long items =
      (long long)BH * ((S + kItemSlots - 1) / kItemSlots);
  if (items == 0) return;
  const long long want = (items + kWarps - 1) / kWarps;
  const long long cap = (long long)ctas_per_sm<PACKED>() * sm_count();
  const int grid = (int)(want < cap ? want : cap);
  const int vec_out = S % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(kscale) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  approx_score_mma_kernel<VEC, PACKED><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(qq), static_cast<const float*>(qscale),
      static_cast<const int8_t*>(kq), static_cast<const float*>(kscale),
      static_cast<const int8_t*>(valid), static_cast<float*>(out), BH, S, G,
      d, vec_out);
}

// The widest mirror load that tiles the row's bytes (d, or d/2 packed) and
// that the pointer's alignment allows.
template <bool PACKED>
void launch(const void* qq, const void* qscale, const void* kq,
            const void* kscale, const void* valid, void* out, int BH, int S,
            int G, int d, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(kq);
  const int rb = PACKED ? d / 2 : d;
  if (rb % 16 == 0 && a % 16 == 0)
    launch_mma<16, PACKED>(qq, qscale, kq, kscale, valid, out, BH, S, G, d,
                           stream);
  else if (rb % 8 == 0 && a % 8 == 0)
    launch_mma<8, PACKED>(qq, qscale, kq, kscale, valid, out, BH, S, G, d,
                          stream);
  else
    launch_mma<4, PACKED>(qq, qscale, kq, kscale, valid, out, BH, S, G, d,
                          stream);
}

}  // namespace

extern "C" {


// packed: 0 = int8 mirror [BH,S,d], 1 = nibble-packed [BH,S,d/2]; one
// kernel body serves both. The caller guarantees d % 8 == 0 and 4-byte
// aligned rows; G outside [1, kMaxG] or G*d above kMaxGD (the accepted
// range of the wrappers, not a buffer's size) is refused, as is a mirror
// of 2^31 items or more. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
int approx_score_launch(int packed, const void* qq, const void* qscale,
                        const void* kq, const void* kscale, const void* valid,
                        void* out, int BH, int S, int G, int d,
                        void* stream) {
  if (G < 1 || G > kMaxG || G * d > kMaxGD)
    return (int)cudaErrorInvalidValue;
  if ((long long)BH * ((S + kItemSlots - 1) / kItemSlots) > 2147483647LL)
    return (int)cudaErrorInvalidValue;  // no card holds such a mirror
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed)
    launch<true>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, st);
  else
    launch<false>(qq, qscale, kq, kscale, valid, out, BH, S, G, d, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
