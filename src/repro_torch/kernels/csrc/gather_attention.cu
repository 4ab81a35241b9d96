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
// Design. One CTA of 256 threads per row (warp and block reductions from
// decode_common.cuh). One warp per gathered row for
// the logits (its K row read once, by 32 lanes side by side; invalid rows
// are not read), the [G][K] logits in shared memory, one block-wide
// softmax per query row, then one thread per output element, walking the
// K value rows whose weight is not 0. The TPU streams K in blocks with an
// online softmax; with K in the hundreds one pass over shared memory
// does the same work in another floating-point order.
//
// Bound. Memory: q, the valid K and V rows and the valid bytes, and out.
// At K = 128 gathered rows of d = dv = 128 bf16 values for 128 rows (the
// served longchat-7b decode shape) that is about 8.4 MB, 2.5 us at
// 3.35 TB/s; the 4·G·d·K flops a row are far below the card's rates.

#include "decode_common.cuh"

using namespace decode;

namespace {

// MAX_G: the per-row accumulators a lane keeps (G <= MAX_G).
template <typename KV, int MAX_G>
__global__ void __launch_bounds__(kThreads) gather_attention_kernel(
    const float* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const int8_t* __restrict__ valid,
    float* __restrict__ out, int K, int G, int d, int dv, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qf = reinterpret_cast<float*>(smem_raw);  // [G][d]
  float* pl = qf + G * d;                          // [G][K]
  float* red = pl + G * K;                         // [kWarps]

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int x = tid; x < G * d; x += kThreads) qf[x] = q[(size_t)row * G * d + x];
  __syncthreads();

  // logits: one warp per gathered row
  const int8_t* valid_row = valid + (size_t)row * K;
  const KV* k_row = k + (size_t)row * K * d;
  for (int j = warp; j < K; j += kWarps) {
    if (valid_row[j] == 0) {
      if (lane == 0)
        for (int g = 0; g < G; ++g) pl[g * K + j] = kNegInf;
      continue;
    }
    const KV* kr = k_row + (size_t)j * d;
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float kv = to_f32(kr[c]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] += qf[g * d + c] * kv;
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) acc[g] = warp_sum(acc[g]);
    if (lane == 0)
      for (int g = 0; g < G; ++g) pl[g * K + j] = __fmul_rn(acc[g], scale);
  }
  __syncthreads();

  // softmax over the K logits of each query row (NEG_INF logits included,
  // as in the oracle)
  for (int g = 0; g < G; ++g) {
    float* p = pl + g * K;
    float mx = -INFINITY;
    for (int j = tid; j < K; j += kThreads) mx = fmaxf(mx, p[j]);
    mx = block_reduce(mx, red, true);
    float z = 0.f;
    for (int j = tid; j < K; j += kThreads) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      z += e;
    }
    z = block_reduce(z, red, false);
    for (int j = tid; j < K; j += kThreads) p[j] = p[j] / z;
  }
  __syncthreads();

  const KV* v_row = v + (size_t)row * K * dv;
  float* out_row = out + (size_t)row * G * dv;
  for (int x = tid; x < G * dv; x += kThreads) {
    const int g = x / dv, c = x - g * dv;
    const float* p = pl + g * K;
    float acc = 0.f;
    for (int j = 0; j < K; ++j)
      if (p[j] != 0.f) acc += p[j] * to_f32(v_row[(size_t)j * dv + c]);
    out_row[x] = acc;
  }
}

// One instantiation for G <= 8 and one for G <= kMaxG (a lane keeps MAX_G
// accumulators in unrolled loops), so G <= 8 keeps the short loops.
template <typename KV>
struct Launch {
  template <int MAX_G>
  static int go(const void* q, const void* k, const void* v,
                const void* valid, void* out, int BH, int K, int G, int d,
                int dv, float scale, size_t smem, cudaStream_t stream) {
    const int err = allow_smem(gather_attention_kernel<KV, MAX_G>, smem);
    if (err != 0) return err;
    gather_attention_kernel<KV, MAX_G><<<BH, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const KV*>(k),
        static_cast<const KV*>(v), static_cast<const int8_t*>(valid),
        static_cast<float*>(out), K, G, d, dv, scale);
    return (int)cudaGetLastError();
  }

  static int run(const void* q, const void* k, const void* v,
                 const void* valid, void* out, int BH, int K, int G, int d,
                 int dv, float scale, size_t smem, cudaStream_t stream) {
    return G <= 8 ? go<8>(q, k, v, valid, out, BH, K, G, d, dv, scale, smem,
                          stream)
                  : go<kMaxG>(q, k, v, valid, out, BH, K, G, d, dv, scale,
                              smem, stream);
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes.
size_t gather_attention_smem_bytes(int K, int G, int d) {
  return sizeof(float) * ((size_t)G * d + (size_t)G * K + kWarps);
}

// kv_kind: 0 = f32, 1 = bf16, 2 = int8 K/V; 1 <= G <= kMaxG (16).
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// never synchronises.
int gather_attention_launch(int kv_kind, const void* q, const void* k,
                            const void* v, const void* valid, void* out,
                            int BH, int K, int G, int d, int dv, float scale,
                            void* stream) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  return by_kv_kind<Launch>(kv_kind, q, k, v, valid, out, BH, K, G, d, dv,
                            scale, gather_attention_smem_bytes(K, G, d),
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
