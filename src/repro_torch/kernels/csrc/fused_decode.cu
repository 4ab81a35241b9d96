// Fused pruned decode with a block-local CAM race, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_decode` of the reference package
// (src/repro/kernels/fused_decode.py: wrapper `fused_decode`, body
// `_fused_decode_kernel`): the paper's per-array CAM race, where each of
// num_blocks equal selection blocks of S / num_blocks slots races its own
// slots for k_loc = select_k / num_blocks winners. Per row i of [B*Hk]:
//   1. CAM scoring of all S slots:
//        score[g][s] = (qq[g]·mirror[s]) * qscale[g] * mscale[s],
//      NEG_INF at invalid slots (dp4a on the int8 codes: exact in int32);
//   2. the block-local race: ssel[s] = Σ_g score[g][s] in row order,
//      protected slots get PROT_WIN, then each block picks k_loc winners by
//      argmax rounds (first max wins; each pick is marked PICKED);
//   3. the winner gather: only the winners' K/V rows are read, times
//      kscale / vscale (K and V are f32, bf16 or int8: a template);
//   4. exact softmax attention over all select_k winners → out [G][dv]
//      (one softmax; the TPU's online softmax across blocks is only another
//      floating-point order);
//   5. the charge-domain probabilities probs[s] = Σ_g softmax_g(score/√d),
//      exactly 0 at invalid slots.
//
// Design. One CTA of 256 threads per row, as ragged_decode.cu, whose
// scoring, attention and probability stages it shares (decode_common.cuh).
// The TPU walks the blocks in grid order with an online softmax carried in
// VMEM; here the [G][S] score buffer lives in shared memory and the race
// runs one warp per selection block: each lane keeps the best of the
// block's slots it owns, a round is one warp-shuffle argmax, and only the
// owner of the pick rescans its slots, so the race needs no CTA barrier per
// round (with num_blocks > 8 a warp races several blocks in turn). A row
// with no valid slot picks only invalid slots and gives out = 0, probs = 0.
//
// Bound. Memory: per row the kernel must read the whole mirror (S x d
// bytes), its scales, the valid and protection bytes, and the K/V rows and
// scales of the valid winners, and write probs [S] and out [G][dv]. At the
// served shape of longchat-7b with select_blocks = 4 (128 rows, S = 1088,
// d = 128, select_k = 128, bf16 K/V) that is about 28 MB per launch, some
// 8.5 us at 3.35 TB/s, as chip_smoke.py reckons it from its inputs. The
// integer scoring (2·G·d·S ops a row) and the f32 attention are far below
// the card's rates. This first kernel is correct and simple, not fast: its
// measured time against the bound is in PERF.md.

#include "decode_common.cuh"

using namespace decode;

namespace {

template <typename KV>
__global__ void __launch_bounds__(kThreads) fused_decode_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ qq,
    const float* __restrict__ qscale, const int8_t* __restrict__ mirror,
    const float* __restrict__ mscale, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int8_t* __restrict__ valid,
    const int8_t* __restrict__ prot, const KV* __restrict__ k,
    const KV* __restrict__ v, float* __restrict__ out,
    float* __restrict__ probs, int S, int G, int d, int dv, int select_k,
    int num_blocks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem m = carve(smem_raw, S, G, d, select_k);

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int8_t* valid_row = valid + (size_t)row * S;

  // -- 1. CAM scoring of every slot ----------------------------------------
  stage_queries(m, q + (size_t)row * G * d, qq + (size_t)row * G * d, S, G, d,
                S);
  score_slots(m, mirror + (size_t)row * S * d, mscale + (size_t)row * S,
              qscale + (size_t)row * G, valid_row, S, G, d, S);

  // -- 2. the block-local race: one warp per selection block ---------------
  selection_sums(m, prot + (size_t)row * S, S, G);
  float* ssel = m.ssel;
  const int bs = S / num_blocks, k_loc = select_k / num_blocks;
  for (int b = warp; b < num_blocks; b += kWarps) {
    const int lo = b * bs, hi = lo + bs;
    // each lane keeps the best of the block's slots it owns
    // (s ≡ lo + lane mod 32); after a pick only the owner rescans
    float bv = -INFINITY;
    int bi = INT_MAX;
    auto rescan = [&]() {
      bv = -INFINITY;
      bi = INT_MAX;
      for (int s = lo + lane; s < hi; s += 32)
        if (beats(ssel[s], s, bv, bi)) {
          bv = ssel[s];
          bi = s;
        }
    };
    rescan();
    for (int r = 0; r < k_loc; ++r) {
      float cv = bv;
      int ci = bi;
      warp_argmax(cv, ci);  // every lane gets the block's winner
      if (lane == 0) m.picks[b * k_loc + r] = ci;
      if ((ci - lo) % 32 == lane) {
        ssel[ci] = kPicked;
        rescan();
      }
    }
  }
  __syncthreads();

  // -- 3+4. exact attention over all select_k winners ----------------------
  attend_winners<KV>(m, k + (size_t)row * S * d, v + (size_t)row * S * dv,
                     kscale + (size_t)row * S, vscale + (size_t)row * S,
                     valid_row, out + (size_t)row * G * dv, G, d, dv,
                     select_k, scale);

  // -- 5. charge-domain probabilities from the score buffer -----------------
  charge_probs(m, probs + (size_t)row * S, S, G, scale);
}

template <typename KV>
struct Launch {
  static int run(const void* q, const void* qq, const void* qscale,
                 const void* mirror, const void* mscale, const void* kscale,
                 const void* vscale, const void* valid, const void* prot,
                 const void* k, const void* v, void* out, void* probs, int BH,
                 int S, int G, int d, int dv, int select_k, int num_blocks,
                 float scale, cudaStream_t stream) {
    const size_t smem = smem_bytes(S, G, d, select_k);
    const int err = allow_smem(fused_decode_kernel<KV>, smem);
    if (err != 0) return err;
    fused_decode_kernel<KV><<<BH, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(qq),
        static_cast<const float*>(qscale), static_cast<const int8_t*>(mirror),
        static_cast<const float*>(mscale), static_cast<const float*>(kscale),
        static_cast<const float*>(vscale), static_cast<const int8_t*>(valid),
        static_cast<const int8_t*>(prot), static_cast<const KV*>(k),
        static_cast<const KV*>(v), static_cast<float*>(out),
        static_cast<float*>(probs), S, G, d, dv, select_k, num_blocks, scale);
    return (int)cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes.
size_t fused_decode_smem_bytes(int S, int G, int d, int select_k) {
  return smem_bytes(S, G, d, select_k);
}

// kv_kind: 0 = f32, 1 = bf16, 2 = int8 K/V. The caller guarantees
// S % num_blocks == 0, select_k % num_blocks == 0 and
// select_k / num_blocks <= S / num_blocks. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
int fused_decode_launch(int kv_kind, const void* q, const void* qq,
                        const void* qscale, const void* mirror,
                        const void* mscale, const void* kscale,
                        const void* vscale, const void* valid,
                        const void* prot, const void* k, const void* v,
                        void* out, void* probs, int BH, int S, int G, int d,
                        int dv, int select_k, int num_blocks, float scale,
                        void* stream) {
  return by_kv_kind<Launch>(kv_kind, q, qq, qscale, mirror, mscale, kscale,
                            vscale, valid, prot, k, v, out, probs, BH, S, G,
                            d, dv, select_k, num_blocks, scale,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
