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
//
// Two routes, one function: that single-CTA row (decode_row) wherever its
// shared memory fits, which is every served shape, and the long route of
// decode_long.cuh (a score grid, then a cluster of CTAs a row racing and
// attending over device-memory scratch) at any larger S, up to long_500k's
// 524,288 slots. The wrapper picks by the row's layout. On a cache whose
// slots are split over ranks, the wrapper runs the long route's kernels
// one stage a launch on the rank's block (LaunchShard): the global race's
// candidates a rank, the ranks' candidates raced again for the global
// winners (shard_merge_kernel), the attention's partials over the winners
// the rank holds, and probs from the row's merged (max, sum). The blocked
// race of one selection block a rank (fused_decode's, over as many ranks
// as blocks) runs here too: every slot of the block scored, its race
// final. The collectives between the launches are the wrapper's.

#include "decode_common.cuh"
#include "decode_long.cuh"

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

// Dynamic shared memory one CTA of the single-CTA route needs, in bytes.
size_t ragged_decode_smem_bytes(int S, int G, int d, int dv, int select_k,
                                int kv_kind) {
  return layout(S, G, d, dv, select_k, kv_bytes(kv_kind), 1).total;
}

// Dynamic shared memory of one CTA of the long route's score kernel
// (kernel 0) or race kernel (kernel 1), in bytes: independent of S and
// select_k, which it takes only to say so.
size_t ragged_decode_long_smem_bytes(int S, int G, int d, int dv,
                                     int select_k, int kv_kind, int kernel) {
  (void)S;
  (void)select_k;
  return kernel == 0 ? score_layout(G, d).total
                     : race_layout(G, d, dv, kv_bytes(kv_kind)).total;
}

// Device scratch the long route needs for one launch, in bytes.
size_t ragged_decode_long_scratch_bytes(int BH, int S, int G, int select_k) {
  return long_scratch(BH, S, G, 1, select_k, nullptr, nullptr);
}

// route: 0 = the single-CTA row, 1 = the long route, whose `scratch` holds
// ragged_decode_long_scratch_bytes (the other route ignores it).
// kv_kind: 0 = f32, 1 = bf16, 2 = int8 K/V. The caller guarantees the
// mirror is 16-byte aligned when d % 16 == 0 (else 4-byte), K and V
// aligned to the widest of 16, 8, 4 bytes that divides their rows' bytes,
// and scratch 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
int ragged_decode_launch(int route, int kv_kind, const void* fills,
                         const void* q, const void* qq, const void* qscale,
                         const void* mirror, const void* mscale,
                         const void* kscale, const void* vscale,
                         const void* valid, const void* prot, const void* k,
                         const void* v, void* out, void* probs, void* scratch,
                         int BH, int S, int G, int d, int dv, int select_k,
                         int block_s, float scale, void* stream) {
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) return by_kind<Launch>(d, kv_kind, p, BH, st);
  return by_kind<LaunchLong>(d, kv_kind, p, BH, scratch, st);
}

// The sharded route's device scratch for one call over a block of S slots
// with select_k picks a row, in bytes; offs[0..3] take the byte offsets of
// its candidates ([BH][select_k] int2), the rows' (max, sum of exp)
// ([BH][G] float2, global once the wrapper has merged them), the
// attention partials' (max, den) ([BH][G] float2) and the picks
// ([BH][select_k] int, slots of the block).
size_t ragged_decode_shard_scratch_bytes(int BH, int S, int G, int select_k,
                                         size_t* offs) {
  return long_scratch(BH, S, G, 1, select_k, nullptr, nullptr, true, offs);
}

// One stage of the sharded route (decode_long.cuh, LaunchShard) on this
// rank's block of S slots from global slot `offset`: `fills` holds the
// block's own live counts (rounded up to `block_s`), or is null to score
// every slot (the blocked race, block_s = S); select_k is the stage's
// race size, scratch_k the picks the scratch was carved for; `cand`
// ([n][BH][kc] int2) only for stage 1. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
int ragged_decode_shard_launch(int stage, int mode, int kv_kind,
                               const void* fills, const void* q, const void* qq,
                               const void* qscale, const void* mirror,
                               const void* mscale, const void* kscale,
                               const void* vscale, const void* valid,
                               const void* prot, const void* k, const void* v,
                               void* out, void* probs, void* scratch, int BH,
                               int S, int G, int d, int dv, int select_k,
                               int scratch_k, int block_s, float scale,
                               int offset, const void* cand, int n, int kc,
                               void* stream) {
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
  return by_kind<LaunchShard>(d, kv_kind, p, BH, scratch, scratch_k, stage,
                              mode, offset, cand, n, kc,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
