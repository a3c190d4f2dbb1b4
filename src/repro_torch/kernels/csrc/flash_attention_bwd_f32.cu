// The backward of flash attention (K5b) for f32 inputs, on the SIMT body
// (full f32, for the card-vs-CPU parity runs): the design is in
// flash_attention_bwd.cuh.

#include "flash_attention_bwd.cuh"

// q, out, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D); all
// contiguous and 16-byte aligned, in float32.  lse (B, Hq, Sq) f32 from the
// forward; delta (B, Hq, Sq) f32 scratch.  Hq a multiple of Hkv; D in {64,
// 128, 256}; window <= 0 means no sliding window; query row r sits at
// position q_offset + r (>= 0), keys at 0 .. Skv - 1.  Three launches on
// `stream`; returns the first failing launch's cudaError_t (0 = success).
extern "C" int flash_attention_bwd_f32_launch(const void* q, const void* k, const void* v,
                                              const void* out, const void* dout,
                                              const void* lse, void* delta, void* dq, void* dk,
                                              void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                                              int D, int causal, int window, int q_offset,
                                              float scale, void* stream) {
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_simt_d<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                             D, causal, window, q_offset, scale, stream);
}
