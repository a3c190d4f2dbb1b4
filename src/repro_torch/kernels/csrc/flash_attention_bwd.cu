// The backward of flash attention (K5b) for bf16 inputs, on wgmma: the
// design is in flash_attention_bwd.cuh.

#include "flash_attention_bwd.cuh"

// q, out, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D); all
// contiguous and 16-byte aligned, in bfloat16.  lse (B, Hq, Sq) f32 from the
// forward; delta (B, Hq, Sq) f32 scratch.  Hq a multiple of Hkv; D in {64,
// 128, 256}; window <= 0 means no sliding window; query row r sits at
// position q_offset + r (>= 0), keys at 0 .. Skv - 1.  The launch plan of
// kernels/flash_attention.py::bwd_plan: a kv head's Hq / Hkv q heads run as
// `cluster` blocks of one thread-block cluster, `heads_per_block` heads a
// block; kv_reverse / q_reverse launch the dK / dV kernel's key tiles and
// the dQ kernel's query tiles last to first.  Three launches on `stream`;
// returns the first failing launch's cudaError_t (0 = success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                                          int window, int q_offset, float scale, int cluster,
                                          int heads_per_block, int kv_reverse, int q_reverse,
                                          void* stream) {
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return wg::launch<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                            causal, window, q_offset, scale, cluster, heads_per_block, kv_reverse,
                            q_reverse, st);
    case 128:
      return wg::launch<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                             causal, window, q_offset, scale, cluster, heads_per_block, kv_reverse,
                             q_reverse, st);
    case 256:
      return wg::launch<256>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                             causal, window, q_offset, scale, cluster, heads_per_block, kv_reverse,
                             q_reverse, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The four tensor maps a launch encodes (q, k, v, dout as above), encoded
// and dropped: the host cost of a launch's encoding, for timing.
extern "C" int flash_attention_bwd_encode(const void* q, const void* k, const void* v,
                                          const void* dout, int B, int Sq, int Skv, int Hq,
                                          int Hkv, int D) {
  CUtensorMap m[4];
  return wg::encode_maps(m, q, k, v, dout, B, Sq, Skv, Hq, Hkv, D);
}
