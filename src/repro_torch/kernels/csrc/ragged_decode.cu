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
// Design. One CTA of 256 threads per row (the stages it shares with
// fused_decode.cu are in decode_common.cuh); it reads its own fill (no scalar
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

#include "decode_common.cuh"

using namespace decode;

namespace {

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
  const Smem m = carve(smem_raw, S, G, d, select_k);

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fill = min(max(fills[row], 0), S);
  const int live = min((fill + block_s - 1) / block_s * block_s, S);
  const int8_t* valid_row = valid + (size_t)row * S;

  // -- 1. CAM scoring over the live blocks; dead slots stay NEG_INF ---------
  stage_queries(m, q + (size_t)row * G * d, qq + (size_t)row * G * d, S, G, d,
                live);
  score_slots(m, mirror + (size_t)row * S * d, mscale + (size_t)row * S,
              qscale + (size_t)row * G, valid_row, S, G, d, live);

  // -- 2. the race: G-row sum, protected slots win, select_k argmax rounds --
  selection_sums(m, prot + (size_t)row * S, S, G);
  float* ssel = m.ssel;

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
    warp_argmax(cv, ci);
    if (lane == 0) {
      m.red_v[warp] = cv;
      m.red_i[warp] = ci;
    }
    __syncthreads();
    if (warp == 0) {
      cv = lane < kWarps ? m.red_v[lane] : -INFINITY;
      ci = lane < kWarps ? m.red_i[lane] : INT_MAX;
      warp_argmax(cv, ci);
      if (lane == 0) {
        m.picks[r] = ci;
        ssel[ci] = kPicked;
      }
    }
    __syncthreads();
    if (m.picks[r] % kThreads == tid) rescan();
  }

  // -- 3+4. exact attention over the winners ---------------------------------
  attend_winners<KV>(m, k + (size_t)row * S * d, v + (size_t)row * S * dv,
                     kscale + (size_t)row * S, vscale + (size_t)row * S,
                     valid_row, out + (size_t)row * G * dv, G, d, dv,
                     select_k, scale);

  // -- 5. charge-domain probabilities from the score buffer -----------------
  charge_probs(m, probs + (size_t)row * S, S, G, scale);
}

template <typename KV>
struct Launch {
  static int run(const void* fills, const void* q, const void* qq,
                 const void* qscale, const void* mirror, const void* mscale,
                 const void* kscale, const void* vscale, const void* valid,
                 const void* prot, const void* k, const void* v, void* out,
                 void* probs, int BH, int S, int G, int d, int dv,
                 int select_k, int block_s, float scale,
                 cudaStream_t stream) {
    const size_t smem = smem_bytes(S, G, d, select_k);
    const int err = allow_smem(ragged_decode_kernel<KV>, smem);
    if (err != 0) return err;
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
};

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes.
size_t ragged_decode_smem_bytes(int S, int G, int d, int select_k) {
  return smem_bytes(S, G, d, select_k);
}

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
  return by_kv_kind<Launch>(kv_kind, fills, q, qq, qscale, mirror, mscale,
                            kscale, vscale, valid, prot, k, v, out, probs, BH,
                            S, G, d, dv, select_k, block_s, scale,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
