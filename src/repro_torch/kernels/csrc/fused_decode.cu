// Fused pruned decode with a block-local CAM race, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_decode` of the reference package
// (src/repro/kernels/fused_decode.py: wrapper `fused_decode`, body
// `_fused_decode_kernel`): the paper's per-array CAM race, where each of
// num_blocks equal selection blocks of S / num_blocks slots races its own
// slots for k_loc = select_k / num_blocks winners. Per row i of [B*Hk]: CAM
// scoring of all S slots (NEG_INF at invalid slots), the block-local race
// (protected slots win; ties to the lower slot, as lax.top_k), exact
// softmax attention over all valid winners' K/V rows times kscale / vscale
// (one softmax: the TPU's online softmax across blocks is only another
// floating-point order), and the charge-domain probabilities, exactly 0 at
// invalid slots. A row with no valid slot writes out = 0, probs = 0.
//
// Bound. Memory: the whole mirror (S x d bytes, the valid rows counted),
// its scales, the valid and protection bytes, and the valid winners' K/V
// rows and scales; at the served shape of longchat-7b with select_blocks =
// 4 (128 rows, S = 1088, d = 128, select_k = 128, bf16 K/V) 25.1 MB a
// launch, some 7.5 us at 3.35 TB/s, as chip_smoke.py reckons it from its
// inputs. The integer scores and the f32 attention are far below the
// card's rates.
//
// Design: ragged_decode.cu's (decode_common.cuh), with every slot live.
// The TPU kernel walks the blocks in grid order with an online softmax in
// VMEM and races k_loc argmax rounds a block. Carried over as they are (a
// warp per slot with one 4-byte load a lane in flight, k_loc shuffle
// rounds a block), that is some 27x the bound. Here the
// mirror streams through the shared-memory ring by bulk copies (TMA), and
// each selection block is raced by one warp with the same radix select the
// ragged kernel runs across its CTA: four histogram passes in the warp's
// own shared-memory histogram (the first counted while scoring when there
// are at most 8 blocks), no CTA barrier, whatever k_loc is; one block is
// raced by the whole CTA. Its time against the bound is in PERF.md.

#include "decode_common.cuh"

using namespace decode;

namespace {

template <int VEC, typename KV>
__global__ void __launch_bounds__(kThreads, 1)
    fused_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  decode_row<VEC, KV>(p, smem_raw, blockIdx.x, p.S);
}

template <int VEC, typename KV>
struct Launch {
  static int run(const Params& p, int BH, cudaStream_t stream) {
    const size_t smem = layout(p.S, p.G, p.d, p.dv, p.select_k,
                               (int)sizeof(KV), p.num_blocks)
                            .total;
    return launch(fused_decode_kernel<VEC, KV>, p, BH, smem, stream);
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes.
size_t fused_decode_smem_bytes(int S, int G, int d, int dv, int select_k,
                               int num_blocks, int kv_kind) {
  return layout(S, G, d, dv, select_k, kv_bytes(kv_kind), num_blocks).total;
}

// kv_kind: 0 = f32, 1 = bf16, 2 = int8 K/V. The caller guarantees
// S % num_blocks == 0, select_k % num_blocks == 0 and
// select_k / num_blocks <= S / num_blocks, the mirror 16-byte aligned when
// d % 16 == 0 (else 4-byte), and K and V aligned to the widest of 16, 8, 4
// bytes that divides their rows' bytes. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
int fused_decode_launch(int kv_kind, const void* q, const void* qq,
                        const void* qscale, const void* mirror,
                        const void* mscale, const void* kscale,
                        const void* vscale, const void* valid,
                        const void* prot, const void* k, const void* v,
                        void* out, void* probs, int BH, int S, int G, int d,
                        int dv, int select_k, int num_blocks, float scale,
                        void* stream) {
  const Params p{nullptr,
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
                 num_blocks,
                 S,
                 scale};
  return by_kind<Launch>(d, kv_kind, p, BH,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
