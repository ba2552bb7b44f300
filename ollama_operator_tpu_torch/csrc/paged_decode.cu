// Single-token GQA attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/paged.py ::
// paged_decode_attention_v3 (kernel body _paged_kernel_v3, with
// _flash_page_update and _prep_paged): the live-page walk. The function and
// the pool layout are in paged_common.cuh, shared with the v2 and v4
// kernels: slot b's query at position lengths[b] attends every live page of
// its table (whatever ``nblk`` is), from the window's first block on.
//
// What bounds it on the card: bytes. Each live page is read once per
// (slot, kv head): ps * hd code bytes for K and for V (half that for int4),
// plus 2 * ps f32 scales, against G * ps * hd * 2 multiply-adds, i.e. a few
// operations per byte for G <= 16, far below the card's ~295.
//
// Design (the dense-cache kernel's, decode_attention.cu, carried over to
// pages). The slot's live rows are split over CTAs: the grid is (kv head,
// slot, chunk of ``chunk_pages`` table blocks), so a long slot no longer
// walks its whole chain on one CTA. A CTA folds its chunk's live rows
// [max(lo, z * chunk), min(hi, (z + 1) * chunk - 1)] (lo the window's first
// row, hi = min(lengths[b], NBLK * ps - 1)) into a partial (m, l, acc) in
// f32; a chunk with none stores m = -1e30, l = 0 and exits. A second launch
// (merge_chunks, split_decode.cuh) merges each (kv head, slot, query row)'s
// partials in chunk order, so a repeat gives the same bits. The grid
// depends on NBLK and the chunk only, never on the lengths.
//
// At hd a multiple of 16 (every served model) the chunk runs on tensor
// cores: its 32-position tiles on the tile loop of paged_tiles.cuh
// (fold_tiles, shared with the v2 and v4 kernels; cp.async rings a warp,
// S^T = K . Q^T and O^T += V^T . P^T on mma.sync). Other head dims take the
// scalar page loop of paged_common.cuh (page_update), split over the same
// chunks of blocks. The split launch is paged_tiles.cuh's launch_split with
// the attended width set to the whole table.
//
// Chosen by measurement on the H100 (hack/paged_v3_variants.py, PERF.md):
// one CTA a chunk of 512 positions (ops/paged.py PAGED_CHUNK; fewer CTAs a
// slot, each walking several chunks, were slower).

#include "paged_tiles.cuh"

// q [B, 1, H, hd] bf16; pools [L, P, KvH, ps, hd] int8 or bf16, or
// [L, P, KvH, ps/2, hd] uint8 for int4 (positions 2j and 2j + 1 in the low
// and high nibbles of row j, +8 bias; ps, the logical page size, even);
// scales [L, P, KvH, ps] f32 (not read for bf16); tables [B, NBLK] int32;
// lengths [B] int32 (the query's absolute position); out [B, 1, H, hd]
// bf16. All contiguous, 16-byte aligned. ``nblk`` is not read: this kernel
// walks every live page of the table. The table's blocks are split in
// chunks of ``chunk_pages`` (> 0); part_acc [B * nchunk, KvH, H / KvH, hd]
// and part_ml [B * nchunk, KvH, H / KvH, 2] f32 hold the partials, nchunk
// = ceil(NBLK / chunk_pages). Takes the shapes of paged_shape_ok. Two
// launches on ``stream`` (partials, merge). Returns cudaGetLastError()
// (cudaErrorInvalidValue, and no launch, for a shape or chunk it does not
// take).
#define PAGED_V3_ENTRY(NAME, T, QUANT, PACK4)                                 \
  extern "C" int NAME(const void* q, const void* kq, const void* ks,         \
                      const void* vq, const void* vs, const int* tables,     \
                      const int* lengths, void* out, void* part_acc,         \
                      void* part_ml, int B, int H, int KvH, int hd, int P,   \
                      int ps, int NBLK, int nblk, int layer, float scale,    \
                      float softcap, int window, int chunk_pages,            \
                      void* stream) {                                        \
    if (!paged_shape_ok(B, H, KvH, hd, ps, PACK4, NBLK, NBLK) ||             \
        chunk_pages <= 0)                                                    \
      return (int)cudaErrorInvalidValue;                                     \
    return launch_split<T, QUANT, PACK4>(                                     \
        make_params(q, kq, ks, vq, vs, tables, lengths, out, B, H, KvH, hd,  \
                    P, ps, NBLK, NBLK, layer, scale, softcap, window),       \
        chunk_pages, (float*)part_acc, (float*)part_ml, stream);             \
  }

PAGED_V3_ENTRY(paged_decode_int8, int8_t, true, false)
PAGED_V3_ENTRY(paged_decode_int4, int8_t, true, true)
PAGED_V3_ENTRY(paged_decode_bf16, __nv_bfloat16, false, false)

// 1 when the entries run head dim ``hd`` on the tensor cores
// (paged_mma_kernel), 0 when they take the scalar page loop.
extern "C" int paged_decode_tensor_cores(int hd) {
  return paged_tensor_cores(hd);
}
