// Flash attention in bfloat16: the __nv_bfloat16 instantiations of the
// kernels of flash_attention.cuh, built by an nvcc of their own beside the
// float32 ones (flash_attention.cu), which hold the shared entry points.

#include "flash_attention.cuh"

extern "C" {

// q, k, v and o bfloat16; lse and the parts float32.
int pasnl_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                         void* part, int b, int m, int n, int c, int d, float scale,
                         void* stream) {
  return fwd_any<__nv_bfloat16>(q, k, v, o, lse, part, b, m, n, c, d, scale, stream);
}

// q, k, v, o, dout, dq, dk and dv bfloat16; lse, delta and the partial dQ
// float32.
int pasnl_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                         const void* lse, const void* dout, void* dq, void* dk, void* dv,
                         void* delta, void* dq_part, int b, int m, int n, int c, int d,
                         float scale, void* stream) {
  return bwd_any<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, delta, dq_part, b, m, n, c, d,
                                scale, stream);
}

}  // extern "C"
