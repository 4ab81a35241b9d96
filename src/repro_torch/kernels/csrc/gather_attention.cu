// Exact softmax attention over gathered slots, for Hopper (sm_90a).
//
// Replaces the TPU kernel `gather_attention` of the reference package
// (src/repro/kernels/gather_attention.py: wrapper `gather_attention`, body
// `_gather_attn_kernel`): the current-domain stage of the composed decode
// path, after the top-k gather has laid the K winners of each row side by
// side. For every row i of [B*Hk] and query row g of its GQA group:
//   logit[g][j] = (q[g]·k[j]) / sqrt(d), NEG_INF where valid[j] == 0,
//   out[g]      = Σ_j softmax_j(logit[g])[j] · v[j].
// Invalid slots are not masked out of the softmax beyond their NEG_INF
// logit, as in the reference's oracle: a row with no valid slot gets equal
// logits and so the mean of its K value rows.
//
// Bound. Memory: q, the valid K and V rows (every V row of a row with no
// valid slot), the valid bytes, and out. At K = 128 gathered rows of
// d = dv = 128 bf16 values for 128 rows (the served longchat-7b decode
// shape) that is about 8.4 MB, 2.5 us at 3.35 TB/s. The products are
// matrix-vector sized, 4·G·d·K flops against (d + dv)·K·bytes a row (at
// most 32 flops a bf16 byte at G = 16), far below the ~300 a byte where
// the tensor cores would pay: the kernel runs on the CUDA cores.
//
// Design. One CTA of 256 threads a row. What it does about the bound:
//   1. All of a row's bytes are asked for at once. Each thread reads its
//      rows' valid bytes and starts the 1-D bulk copies (cp.async.bulk, the
//      TMA) of its valid K rows onto one mbarrier and of the V rows onto
//      another, so the logits start while V is still arriving; at the
//      served shape that is 64 KB a CTA and the whole 8.4 MB in flight
//      together. Only the valid rows are read (a row with no valid slot
//      reads every V row and no K). Rows that do not fit beside the [G][K]
//      logits (K in the thousands) are read from device memory by the same
//      loops: the stage holds the first `cap` rows, so every K the
//      [G][K] logits admit still launches, with no ring of chunks.
//   2. Logits: one thread a (K row, block of up to four query rows) task,
//      16-byte chunks, each q chunk read by the whole warp at once (a
//      broadcast), the block's sums in registers. K rows sit 16 bytes
//      apart more than their length, so the 32 rows of a warp's reads meet
//      no bank conflict. No shuffles.
//   3. Softmax: one warp a query row, warp reductions only; 1/l goes to
//      the epilogue, no division an element.
//   4. p·v: a warp takes 4 column groups of four (16 columns), its 8 row
//      groups walk the K rows, their sums meet in three shuffles, and the
//      first group writes out * 1/l as float4. V rows are padded by what a
//      row group reads, so the 8 groups' reads meet no bank conflict.
// Query rows in passes of GB = 4 (GB = 1 at G = 1): a CTA runs once on its
// SM and so fetches every instruction of its path from L2, and with loops
// unrolled 8 or 16 query rows wide the code was 68 KB and its stages took
// 2-10x their work (clock stamps on an H100). Rows whose bytes are not multiples of 16
// (int8 at d = 40 or 72), or tensors not 16-byte aligned, take the same
// steps one element at a time from device memory (WIDE = false).
// The TPU streams K in blocks with an online softmax; with K in the
// hundreds one pass over shared memory does the same work in another
// floating-point order. No tensor cores: 4·G·d·K flops against
// (d + dv)·K·bytes a row are matrix-vector sized (above).

#include "decode_common.cuh"

using namespace decode;

namespace {

constexpr int kScratch = 32;  // bytes: the two mbarriers, 16 spare

// N elements of KV at p (aligned to their size) as floats: a 16-byte chunk
// as the decode kernels read one (Chunk), or 8, 4 or 1 element's bytes.
template <typename KV, int N>
__device__ __forceinline__ void load_f32(const unsigned char* p, float* f) {
  constexpr int B = N * (int)sizeof(KV);
  if constexpr (B == 16) {
    Chunk<KV>::load(reinterpret_cast<const KV*>(p), f);
  } else if constexpr (B == 8) {
    const int2 raw = *reinterpret_cast<const int2*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
  } else if constexpr (B == 4) {
    const int raw = *reinterpret_cast<const int*>(p);
    const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
  } else {
    static_assert(N == 1, "one element at a time below 4 bytes");
    f[0] = to_f32(*reinterpret_cast<const KV*>(p));
  }
}

constexpr int kVLanes = 4;   // p·v: lanes a row group (four columns each)
constexpr int kVGroups = 8;  // p·v: row groups a warp

// logit[g][j] = (q[g]·k[j]) * scale for the rows j in [j_lo, j_hi) of
// `base` (rows `stride` bytes apart: the stage or device memory, each call
// site with its own address space): one thread a (row, block of GB query
// rows) task, consecutive threads on consecutive rows; the row's NK-element
// chunks in turn, each q chunk read by the whole warp at once (a
// broadcast), the GB sums in registers. pl holds each row's marker in
// every row g (0 for a valid row, NEG_INF for another) until its logit
// replaces it.
template <typename KV, int NK, int GB>
__device__ __forceinline__ void logit_rows(const unsigned char* base,
                                           int stride, int j_lo, int j_hi,
                                           const float* qf, float* pl, int K,
                                           int G, int d, float scale) {
  const int n = j_hi - j_lo, blocks = (G + GB - 1) / GB;
  for (int t = (int)threadIdx.x; t < n * blocks; t += kThreads) {
    int j = j_lo + t, g0 = 0;
    if (blocks > 1) j = j_lo + t % n, g0 = t / n * GB;
    if (pl[(size_t)g0 * K + j] != 0.f) continue;  // invalid: NEG_INF stays
    const unsigned char* kr = base + (size_t)j * stride;
    float acc[GB];
#pragma unroll
    for (int i = 0; i < GB; ++i) acc[i] = 0.f;
    for (int c = 0; c < d; c += NK) {
      float kv[NK];
      load_f32<KV, NK>(kr + (size_t)c * sizeof(KV), kv);
#pragma unroll
      for (int i = 0; i < GB; ++i) {
        if (g0 + i >= G) continue;
        const float* qg = qf + (size_t)(g0 + i) * d + c;
        if constexpr (NK >= 4) {
          const float4* q4 = reinterpret_cast<const float4*>(qg);
#pragma unroll
          for (int e = 0; e < NK / 4; ++e) {
            const float4 x = q4[e];
            acc[i] = fmaf(x.x, kv[4 * e], acc[i]);
            acc[i] = fmaf(x.y, kv[4 * e + 1], acc[i]);
            acc[i] = fmaf(x.z, kv[4 * e + 2], acc[i]);
            acc[i] = fmaf(x.w, kv[4 * e + 3], acc[i]);
          }
        } else {
          acc[i] = fmaf(qg[0], kv[0], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < GB; ++i)
      if (g0 + i < G) pl[(size_t)(g0 + i) * K + j] = __fmul_rn(acc[i], scale);
  }
}

// acc[i][:] += Σ_j p[g0 + i][j] · V row j [cg·PV, cg·PV + PV) over the rows
// j = j0 + vgrp, j0 = j_lo, j_lo + kVGroups, ... below j_hi (every lane
// runs the same trips). A row past j_hi, or one these GB rows g weigh 0 (a
// staged row that was not fetched weighs 0 in every g), is read in bounds
// but counts 0.
template <typename KV, int PV, int GB>
__device__ __forceinline__ void value_rows(const unsigned char* base,
                                           int stride, int j_lo, int j_hi,
                                           const float* pl, int K, int G,
                                           int g0, int cg, int vgrp,
                                           float (&acc)[GB][PV]) {
#pragma unroll 2
  for (int j0 = j_lo; j0 < j_hi; j0 += kVGroups) {
    const int j = min(j0 + vgrp, j_hi - 1);
    const bool in = j0 + vgrp < j_hi;
    float p[GB];
    bool used = false;
#pragma unroll
    for (int i = 0; i < GB; ++i) {
      p[i] = g0 + i < G && in ? pl[(size_t)(g0 + i) * K + j] : 0.f;
      used = used || p[i] != 0.f;
    }
    float x[PV];
    load_f32<KV, PV>(base + (size_t)j * stride + (size_t)cg * PV * sizeof(KV),
                     x);
#pragma unroll
    for (int i = 0; i < GB; ++i)
#pragma unroll
      for (int e = 0; e < PV; ++e)
        acc[i][e] = fmaf(p[i], used ? x[e] : 0.f, acc[i][e]);
  }
}

// WIDE: K and V rows are multiples of 16 bytes and 16-byte aligned (staged
// by bulk copies, read 16 bytes a chunk for the logits and four elements
// a lane for p·v). GB: the query rows a pass keeps in registers (1 when
// G = 1, else 4: short code at every G). cap: rows
// staged in shared memory (0 unless WIDE); k_stride, v_stride: bytes
// between staged K and V rows.
template <typename KV, bool WIDE, int GB>
__global__ void __launch_bounds__(kThreads, 1) gather_attention_kernel(
    const float* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const int8_t* __restrict__ valid,
    float* __restrict__ out, int K, int G, int d, int dv, float scale,
    int cap, int k_stride, int v_stride) {
  constexpr int NK = WIDE ? 16 / (int)sizeof(KV) : 1;  // logit chunk
  constexpr int PV = WIDE ? 4 : 1;                     // p·v columns a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bar_k = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* bar_v = bar_k + 1;
  float* qf = reinterpret_cast<float*>(smem_raw + kScratch);  // [G][d]
  float* inv_l = qf;  // [G], once the logits are done
  float* pl = qf + (size_t)G * d;                             // [G][K]
  const size_t stage_at =
      align16(kScratch + 4 * ((size_t)G * d + (size_t)G * K));
  unsigned char* kst = smem_raw + stage_at;
  const int k_rb = d * (int)sizeof(KV), v_rb = dv * (int)sizeof(KV);
  unsigned char* vst = kst + (size_t)cap * k_stride;

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* valid_row = valid + (size_t)row * K;
  const unsigned char* kg =
      reinterpret_cast<const unsigned char*>(k + (size_t)row * K * d);
  const unsigned char* vg =
      reinterpret_cast<const unsigned char*>(v + (size_t)row * K * dv);

  // -- 1. every row at once: q by cp.async, the valid rows' K and V by bulk
  //       copies (each thread its rows'), a marker a row in pl
  if (cap > 0 && tid == 0) {
    mbar_init(bar_k);
    mbar_init(bar_v);
    mbar_init_fence();
  }
  copy_to_smem(qf, q + (size_t)row * G * d, 4 * G * d);
  cp_async_commit();
  __syncthreads();  // the barriers are set up
  if (cap > 0) fence_async_shared();
  int staged = 0;    // valid rows below cap
  bool any = false;  // a valid row at all
  for (int j0 = 0; j0 < K; j0 += kThreads) {
    const int j = j0 + tid;
    const bool ok = j < K && valid_row[j] != 0;
    if (j < K)
      for (int g = 0; g < G; ++g) pl[(size_t)g * K + j] = ok ? 0.f : kNegInf;
    if (ok && j < cap) {
      bulk_copy(kst + (size_t)j * k_stride, kg + (size_t)j * k_rb, k_rb,
                bar_k);
      bulk_copy(vst + (size_t)j * v_stride, vg + (size_t)j * v_rb, v_rb,
                bar_v);
    }
    if (j0 < cap) staged += __syncthreads_count(ok && j < cap);
    any = __syncthreads_or(ok) || any;
  }
  const int ns = min(cap, K);  // rows in the stage
  if (cap > 0) {
    if (!any)  // the mean of every V row: all of them
      for (int j = tid; j < ns; j += kThreads)
        bulk_copy(vst + (size_t)j * v_stride, vg + (size_t)j * v_rb, v_rb,
                  bar_v);
    if (tid == 0) {
      mbar_expect(bar_k, (uint32_t)(staged * k_rb));
      mbar_expect(bar_v, (uint32_t)((any ? staged : ns) * v_rb));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // q and the markers are in place
  if (cap > 0) mbar_wait(bar_k, 0);

  // -- 2. logits: the staged rows from shared memory, the rest from device
  //       memory
  logit_rows<KV, NK, GB>(kst, k_stride, 0, ns, qf, pl, K, G, d, scale);
  if (ns < K) logit_rows<KV, NK, GB>(kg, k_rb, ns, K, qf, pl, K, G, d, scale);
  __syncthreads();  // every logit written; qf is free

  // -- 3. softmax: one warp a query row; 1/l kept for the epilogue ----------
  for (int g = warp; g < G; g += kWarps) {
    float* p = pl + (size_t)g * K;
    float mx = -INFINITY;
    for (int j = lane; j < K; j += 32) mx = fmaxf(mx, p[j]);
    mx = warp_max(mx);
    float z = 0.f;
    for (int j = lane; j < K; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      z += e;
    }
    z = warp_sum(z);
    if (lane == 0) inv_l[g] = z > 0.f ? 1.f / z : 0.f;
  }
  __syncthreads();
  if (cap > 0) mbar_wait(bar_v, 0);

  // -- 4. p·v: a warp kVLanes column groups of PV, its kVGroups row groups
  //       walk the rows; their sums meet in three shuffles
  const int Q = dv / PV;  // column groups (PV divides dv when WIDE)
  const int vsub = lane % kVLanes, vgrp = lane / kVLanes;
  float* out_row = out + (size_t)row * G * dv;
  for (int cg0 = warp * kVLanes; cg0 < Q; cg0 += kWarps * kVLanes) {
    const int cg = cg0 + vsub;
    const bool col = cg < Q;
    for (int g0 = 0; g0 < G; g0 += GB) {
      float acc[GB][PV];
#pragma unroll
      for (int i = 0; i < GB; ++i)
#pragma unroll
        for (int e = 0; e < PV; ++e) acc[i][e] = 0.f;
      value_rows<KV, PV, GB>(vst, v_stride, 0, ns, pl, K, G, g0,
                             col ? cg : 0, vgrp, acc);
      if (ns < K)
        value_rows<KV, PV, GB>(vg, v_rb, ns, K, pl, K, G, g0, col ? cg : 0,
                               vgrp, acc);
#pragma unroll
      for (int o = kVLanes; o < 32; o <<= 1)
#pragma unroll
        for (int i = 0; i < GB; ++i)
#pragma unroll
          for (int e = 0; e < PV; ++e)
            acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
      if (vgrp == 0 && col)
#pragma unroll
        for (int i = 0; i < GB; ++i) {
          if (g0 + i >= G) continue;
          const float r = inv_l[g0 + i];
          float* o = out_row + (size_t)(g0 + i) * dv + (size_t)cg * PV;
          if constexpr (PV == 4)
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[i][0] * r, acc[i][1] * r, acc[i][2] * r,
                            acc[i][3] * r);
          else
            o[0] = acc[i][0] * r;
        }
    }
  }
}

size_t fixed_smem(int K, int G, int d) {
  return kScratch + sizeof(float) * ((size_t)G * d + (size_t)G * K);
}

int smem_optin() {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      limit = (int)kSmemMax;
  }
  return limit;
}

// Instantiations: WIDE or not, and GB = 1 (G = 1) or 4 (G up to kMaxG in
// passes of four query rows).
template <typename KV>
struct Launch {
  template <bool WIDE, int GB>
  static int go(const void* q, const void* k, const void* v,
                const void* valid, void* out, int BH, int K, int G, int d,
                int dv, float scale, cudaStream_t stream) {
    const size_t krb = (size_t)d * sizeof(KV), vrb = (size_t)dv * sizeof(KV);
    const size_t fixed = fixed_smem(K, G, d);
    size_t smem = fixed;
    int cap = 0, k_stride = (int)krb, v_stride = (int)vrb;
    if (WIDE) {
      // K rows padded by 16 bytes (the 32 threads of a warp read 32 rows'
      // chunks at once), V rows by what a row group reads of a row
      // (kVLanes x four elements), so neither meets a bank conflict
      k_stride = (int)krb + 16;
      v_stride = (int)(vrb + align16((size_t)kVLanes * 4 * sizeof(KV)));
      const size_t at = align16(fixed), limit = (size_t)smem_optin();
      const size_t per = (size_t)k_stride + (size_t)v_stride;
      const size_t fit = limit > at ? (limit - at) / per : 0;
      cap = (int)(fit < (size_t)K ? fit : (size_t)K);
      if (cap > 0) smem = at + (size_t)cap * per;
    }
    auto kernel = gather_attention_kernel<KV, WIDE, GB>;
    const int err = allow_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<BH, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), static_cast<const int8_t*>(valid),
        static_cast<float*>(out), K, G, d, dv, scale, cap, k_stride,
        v_stride);
    return (int)cudaGetLastError();
  }

  template <bool WIDE>
  static int by_g(const void* q, const void* k, const void* v,
                  const void* valid, void* out, int BH, int K, int G, int d,
                  int dv, float scale, cudaStream_t stream) {
    return G == 1 ? go<WIDE, 1>(q, k, v, valid, out, BH, K, G, d, dv, scale,
                                stream)
                  : go<WIDE, 4>(q, k, v, valid, out, BH, K, G, d, dv, scale,
                                stream);
  }

  static int run(const void* q, const void* k, const void* v,
                 const void* valid, void* out, int BH, int K, int G, int d,
                 int dv, float scale, cudaStream_t stream) {
    const size_t krb = (size_t)d * sizeof(KV), vrb = (size_t)dv * sizeof(KV);
    const bool wide = krb % 16 == 0 && vrb % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(v) % 16 == 0;
    return wide ? by_g<true>(q, k, v, valid, out, BH, K, G, d, dv, scale,
                             stream)
                : by_g<false>(q, k, v, valid, out, BH, K, G, d, dv, scale,
                              stream);
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at least, in bytes: the [G][d]
// query and [G][K] logits and 32 bytes of scratch. What is left of the
// card's shared memory, up to all K rows, stages K and V rows.
size_t gather_attention_smem_bytes(int K, int G, int d) {
  return fixed_smem(K, G, d);
}

// kv_kind: 0 = f32, 1 = bf16, 2 = int8 K/V; 1 <= G <= kMaxG (16).
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// never synchronises.
int gather_attention_launch(int kv_kind, const void* q, const void* k,
                            const void* v, const void* valid, void* out,
                            int BH, int K, int G, int d, int dv, float scale,
                            void* stream) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (BH == 0) return 0;
  return by_kv_kind<Launch>(kv_kind, q, k, v, valid, out, BH, K, G, d, dv,
                            scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
