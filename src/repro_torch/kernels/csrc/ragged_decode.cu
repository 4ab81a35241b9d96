// Fill-aware fused pruned decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `ragged_decode` of the reference package
// (src/repro/kernels/ragged_decode.py: wrapper `ragged_decode`, body
// `_ragged_decode_kernel`). Per row i of [B*Hk], in one pass: CAM scoring
// of the live mirror blocks only (s < ceil(min(fill, S) / block_s) *
// block_s; dead slots are NEG_INF and never read), the global top-k race
// over all S slots (protected slots win; dead and invalid slots fill the
// rest in slot order, as lax.top_k does), exact softmax attention over the
// valid winners' K/V rows times kscale / vscale (f32, bf16 or int8: a
// template), and the charge-domain probabilities, exactly 0 at dead and
// invalid slots. A row with fill == 0 scores nothing and writes out = 0,
// probs = 0.
//
// Bound. Memory: the live mirror rows (fill x d bytes) with their scale,
// valid and protection bytes, and the valid winners' K/V rows and scales;
// at the served shape of longchat-7b (128 rows = 4 lanes x 32 heads,
// S = 1088, fills 690..1050, d = 128, select_k = 128) 25.6 MB a launch with
// bf16 K/V (21.4 MB int8): 7.6 us (6.4 us) at 3.35 TB/s, as chip_smoke.py
// reckons it from its inputs. The integer scores and the f32 attention are
// far below the card's rates.
//
// Design (decode_common.cuh holds the row body it shares with
// fused_decode.cu). One CTA of 256 threads per row reads its own fill. The
// TPU kernel walks the slot blocks in grid order with a VMEM score buffer
// and then races select_k rounds of argmax. Carried over as they are, a
// warp per slot keeps one 4-byte load a lane in flight and the race costs
// two CTA barriers a round: some 35x the bound. Here the live mirror rows
// stream through a ring of 32 KB shared-memory tiles, each one bulk copy
// (TMA) on an mbarrier, one thread scores one slot, and the race is one
// radix select across the CTA: four 8-bit histogram passes (the first
// counted while scoring), three barriers each, whatever select_k is. The
// valid winners' K rows arrive by bulk copies while the probabilities are
// computed, their V rows while the logits are. Its time against the bound
// is in PERF.md.

#include "decode_common.cuh"

using namespace decode;

namespace {

template <int VEC, typename KV>
__global__ void __launch_bounds__(kThreads, 1)
    ragged_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row = blockIdx.x;
  const int fill = min(max(p.fills[row], 0), p.S);
  const int live =
      min((fill + p.block_s - 1) / p.block_s * p.block_s, p.S);
  decode_row<VEC, KV>(p, smem_raw, row, live);
}

template <int VEC, typename KV>
struct Launch {
  static int run(const Params& p, int BH, cudaStream_t stream) {
    const size_t smem =
        layout(p.S, p.G, p.d, p.dv, p.select_k, (int)sizeof(KV), 1).total;
    return launch(ragged_decode_kernel<VEC, KV>, p, BH, smem, stream);
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes.
size_t ragged_decode_smem_bytes(int S, int G, int d, int dv, int select_k,
                                int kv_kind) {
  return layout(S, G, d, dv, select_k, kv_bytes(kv_kind), 1).total;
}

// kv_kind: 0 = f32, 1 = bf16, 2 = int8 K/V. The caller guarantees the
// mirror is 16-byte aligned when d % 16 == 0 (else 4-byte), and K and V
// aligned to the widest of 16, 8, 4 bytes that divides their rows' bytes.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// never synchronises.
int ragged_decode_launch(int kv_kind, const void* fills, const void* q,
                         const void* qq, const void* qscale,
                         const void* mirror, const void* mscale,
                         const void* kscale, const void* vscale,
                         const void* valid, const void* prot, const void* k,
                         const void* v, void* out, void* probs, int BH, int S,
                         int G, int d, int dv, int select_k, int block_s,
                         float scale, void* stream) {
  const Params p{static_cast<const int*>(fills),
                 static_cast<const float*>(q),
                 static_cast<const int8_t*>(qq),
                 static_cast<const float*>(qscale),
                 static_cast<const int8_t*>(mirror),
                 static_cast<const float*>(mscale),
                 static_cast<const float*>(kscale),
                 static_cast<const float*>(vscale),
                 static_cast<const int8_t*>(valid),
                 static_cast<const int8_t*>(prot),
                 k,
                 v,
                 static_cast<float*>(out),
                 static_cast<float*>(probs),
                 S,
                 G,
                 d,
                 dv,
                 select_k,
                 1,
                 block_s,
                 scale};
  return by_kind<Launch>(d, kv_kind, p, BH,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
