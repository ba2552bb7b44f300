// Single-token GQA attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/paged.py ::
// paged_decode_attention_v3 (kernel body _paged_kernel_v3, with
// _flash_page_update and _prep_paged): the live-page walk, one program per
// slot. The function, the per-page code and the pool layout are in
// paged_common.cuh, shared with the v2 and v4 kernels.
//
// What bounds it on the card: bytes. Each live page is read once per
// (slot, kv head): ps * hd code bytes for K and for V (half that for int4),
// plus 2 * ps f32 scales, against G * ps * hd * 2 multiply-adds, i.e. a few
// operations per byte for G = 3 or 4, far below the card's ~295 operations
// per byte.
//
// Design: one CTA of 128 threads per (kv head, slot) walks the slot's live
// pages [start, lengths[b] / ps] in block order (start from the window),
// within the table's NBLK blocks whatever the attended width is, as v3
// walks every live page; it reads its own block-table row and length in
// place of the TPU's scalar prefetch. The layer index is a plain argument,
// so the full [L, P, ...] pool is addressed in place.

#include "paged_common.cuh"

namespace {

using namespace paged;

template <typename T, bool QUANT, bool PACK4>
__global__ void __launch_bounds__(NTHREADS) paged_decode_kernel(Params a) {
  extern __shared__ float smem[];
  const int G = a.H / a.KvH;
  const Smem sm(smem, G, a.hd, a.ps, sizeof(T));
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int qp = a.lengths[b];
  int nlive = qp / a.ps + 1;
  if (nlive > a.NBLK) nlive = a.NBLK;
  int start = 0;
  if (a.window > 0) {
    const int lo = (qp - a.window + 1) / a.ps;
    if (lo > 0) start = lo;
  }
  load_q(a, sm, G, b, kvh);
  State st;
  init_state(st);
  for (int i = start; i < nlive; ++i)
    page_update<T, QUANT, PACK4>(a, sm, st, G, b, kvh, i, qp);
  store_out(a, st, G, b, kvh);
}

template <typename T, bool QUANT, bool PACK4>
int launch(const Params& a, void* stream) {
  static size_t granted = 48 << 10;
  const size_t smem =
      sizeof(float) * smem_floats(a.H / a.KvH, a.hd, a.ps, sizeof(T));
  allow_smem(paged_decode_kernel<T, QUANT, PACK4>, smem, granted);
  dim3 grid(a.KvH, a.B);
  paged_decode_kernel<T, QUANT, PACK4>
      <<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, 1, H, hd] bf16; pools [L, P, KvH, ps, hd] int8 or bf16, or
// [L, P, KvH, ps/2, hd] uint8 for int4 (positions 2j and 2j + 1 in the low
// and high nibbles of row j, +8 bias; ps, the logical page size, even);
// scales [L, P, KvH, ps] f32 (not read for bf16); tables [B, NBLK] int32;
// lengths [B] int32 (the query's absolute position); out [B, 1, H, hd]
// bf16. All contiguous. ``nblk`` is not read: this kernel walks every live
// page of the table. The wrapper checks H % KvH == 0, H / KvH <= 8,
// ps <= 128, hd % 4 == 0 and hd <= 256. Returns cudaGetLastError().
#define PAGED_V3_ENTRY(NAME, T, QUANT, PACK4)                                \
  extern "C" int NAME(const void* q, const void* kq, const void* ks,        \
                      const void* vq, const void* vs, const int* tables,    \
                      const int* lengths, void* out, int B, int H, int KvH, \
                      int hd, int P, int ps, int NBLK, int nblk, int layer, \
                      float scale, float softcap, int window,               \
                      void* stream) {                                       \
    if (PACK4 && ps % 2) return (int)cudaErrorInvalidValue;                 \
    return launch<T, QUANT, PACK4>(                                          \
        make_params(q, kq, ks, vq, vs, tables, lengths, out, B, H, KvH, hd, \
                    P, ps, NBLK, nblk, layer, scale, softcap, window),      \
        stream);                                                             \
  }

PAGED_V3_ENTRY(paged_decode_int8, int8_t, true, false)
PAGED_V3_ENTRY(paged_decode_int4, int8_t, true, true)
PAGED_V3_ENTRY(paged_decode_bf16, __nv_bfloat16, false, false)
