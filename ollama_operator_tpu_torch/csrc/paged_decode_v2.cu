// Single-token GQA attention over the first ``nblk`` blocks of the paged KV
// pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/paged.py ::
// paged_decode_attention (the v2 grid kernel, body _paged_kernel): grid
// (B, nblk), a page across all kv heads per step, the per-head flash updates
// unrolled, blocks past the slot's last live one (or wholly outside the
// window) elided. Its contract: keys in the first ``nblk`` blocks of the
// table only. The function and the pool layout are in paged_common.cuh,
// shared with the v3 and v4 kernels.
//
// What bounds it on the card: bytes, as for the v3 kernel (each live page
// read once per (slot, kv head)), plus the partials: G * hd + 2 f32 per
// live (slot, chunk, kv head) written and read back once.
//
// Design. K4's function is the v3 kernel's over the first nblk blocks of
// the table, so it runs the v3 kernel's split launch (paged_tiles.cuh
// launch_split) with the attended width cut to nblk: grid (kv head, slot,
// chunk of ``chunk_pages`` blocks of [0, nblk)), each CTA folding its
// chunk's live rows on the tensor-core tile loop (fold_tiles: cp.async
// rings a warp, mma.sync; at hd not a multiple of 16 the scalar page
// loop), a chunk with no live row storing m = -1e30, l = 0; a second launch
// (merge_chunks, split_decode.cuh) merges each (kv head, slot, query row)'s
// partials in chunk order with their (m, l) staged in shared memory, so a
// repeat gives the same bits. The TPU's grid is (slot, block); blocks of a
// CTA grid run in no order and carry nothing between them, so the block
// axis becomes the chunk axis of the split, at one CTA per chunk of 512
// positions (ops/paged.py PAGED_CHUNK) rather than per page (chip_smoke.py
// times one page a CTA beside it, PERF.md).

#include "paged_tiles.cuh"

// Arguments as paged_decode.cu's entries; the kernel attends blocks
// [0, nblk) of each slot's table (1 <= nblk <= NBLK): part_acc [B * nchunk,
// KvH, H / KvH, hd] and part_ml [B * nchunk, KvH, H / KvH, 2] f32, nchunk =
// ceil(nblk / chunk_pages). Two launches on ``stream`` (partials, merge).
// Returns cudaGetLastError() (cudaErrorInvalidValue, and no launch, for a
// shape, width or chunk it does not take).
#define PAGED_V2_ENTRY(NAME, T, QUANT, PACK4)                                \
  extern "C" int NAME(const void* q, const void* kq, const void* ks,        \
                      const void* vq, const void* vs, const int* tables,    \
                      const int* lengths, void* out, void* part_acc,        \
                      void* part_ml, int B, int H, int KvH, int hd, int P,  \
                      int ps, int NBLK, int nblk, int layer, float scale,   \
                      float softcap, int window, int chunk_pages,           \
                      void* stream) {                                       \
    if (!paged_shape_ok(B, H, KvH, hd, ps, PACK4, NBLK, nblk) ||            \
        chunk_pages <= 0)                                                   \
      return (int)cudaErrorInvalidValue;                                    \
    return launch_split<T, QUANT, PACK4>(                                    \
        make_params(q, kq, ks, vq, vs, tables, lengths, out, B, H, KvH, hd, \
                    P, ps, NBLK, nblk, layer, scale, softcap, window),      \
        chunk_pages, (float*)part_acc, (float*)part_ml, stream);            \
  }

PAGED_V2_ENTRY(paged_decode_v2_int8, int8_t, true, false)
PAGED_V2_ENTRY(paged_decode_v2_int4, int8_t, true, true)
PAGED_V2_ENTRY(paged_decode_v2_bf16, __nv_bfloat16, false, false)

// 1 when the entries run head dim ``hd`` on the tensor cores, 0 when they
// take the scalar page loop.
extern "C" int paged_decode_v2_tensor_cores(int hd) {
  return paged_tensor_cores(hd);
}
