// Flash attention in float32, and the entry points both element types share
// (widths, scratch sizes): the kernels and their design are in
// flash_attention.cuh, the bfloat16 entry points in flash_attention_bf16.cu.

#include "flash_attention.cuh"

#ifdef FLASH_FWD_PLAN_SWEEP
int g_fwd_force_splits = 0;
#endif

extern "C" {

int pasnl_flash_max_width() { return kMaxWidth; }

// Floats of scratch the forward needs for its key ranges' parts, splits *
// B * M * (D + 2) where a tile's keys are split (0: none, or a width past
// 256).
long long pasnl_flash_fwd_scratch(int b, int m, int n, int c, int d) {
  int splits = 0, split_keys = 0;
  switch (padded_width(c, d)) {
    case 16: fwd_split<16>(b, m, n, splits, split_keys); break;
    case 32: fwd_split<32>(b, m, n, splits, split_keys); break;
    case 64: fwd_split<64>(b, m, n, splits, split_keys); break;
    case 128: fwd_split<128>(b, m, n, splits, split_keys); break;
    case 256: fwd_split<256>(b, m, n, splits, split_keys); break;
    default: break;
  }
  return splits > 1 ? (long long)splits * b * m * (d + 2) : 0;
}

#ifdef FLASH_FWD_PLAN_SWEEP
void pasnl_flash_fwd_force_splits(int splits) { g_fwd_force_splits = splits; }
#endif

// q, k, v and o float32; lse and the parts float32.
int pasnl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, void* part,
                    int b, int m, int n, int c, int d, float scale, void* stream) {
  return fwd_any<float>(q, k, v, o, lse, part, b, m, n, c, d, scale, stream);
}

// Floats of scratch the backward needs for its partial dQ (0: none).
long long pasnl_flash_bwd_scratch(int b, int m, int n, int c, int d) {
  switch (padded_width(c, d)) {
    case 16: return bwd_scratch<16>(b, m, n, c);
    case 32: return bwd_scratch<32>(b, m, n, c);
    case 64: return bwd_scratch<64>(b, m, n, c);
    case 128: return bwd_scratch<128>(b, m, n, c);
    case 256: return bwd_scratch<256>(b, m, n, c);
    default: return 0;
  }
}

// q, k, v, o, dout, dq, dk and dv float32; lse, delta and the partial dQ
// float32.
int pasnl_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* lse,
                    const void* dout, void* dq, void* dk, void* dv, void* delta, void* dq_part,
                    int b, int m, int n, int c, int d, float scale, void* stream) {
  return bwd_any<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, dq_part, b, m, n, c, d, scale,
                        stream);
}

}  // extern "C"
