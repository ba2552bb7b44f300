// Single-token GQA attention over the paged KV pool on a (slot, block)
// grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/paged.py ::
// paged_decode_attention (the v2 grid kernel, body _paged_kernel): grid
// (B, nblk), a page across all kv heads per step, the per-head flash updates
// unrolled, blocks past the slot's last live one (or wholly outside the
// window) elided. Its contract: keys in the first ``nblk`` blocks of the
// table only. The function, the per-page code and the pool layout are in
// paged_common.cuh, shared with the v3 and v4 kernels.
//
// What bounds it on the card: bytes, as for the v3 kernel (each live page
// read once per (slot, kv head)), plus the partials: G * hd + 2 f32 per live
// (slot, block, kv head) written and read back once.
//
// Design. The TPU walks the block axis in order and carries the softmax
// state in scratch; blocks of a CTA grid run in no order, so each
// (kv head, block, slot) gets its own CTA of 128 threads, which folds its
// one page into a fresh state and stores that partial (m, l, acc). A block
// the slot does not need (past lengths[b] / ps, or wholly outside the
// window, the TPU kernel's ``needed``) stores m = NEG_INF, l = 0 and exits.
// A second launch merges each (kv head, slot)'s nblk partials in block
// order (merge_partials<false>), so a repeat gives the same bits. The TPU
// reads a page across all kv heads in one DMA; an int8 llama3.1 page is
// 8 x 128 x 128 B for K and as much for V, more than one CTA's shared
// memory holds with its scores, so the kv head stays a grid axis.

#include "paged_common.cuh"

namespace {

using namespace paged;

template <typename T, bool QUANT, bool PACK4>
__global__ void __launch_bounds__(NTHREADS)
paged_v2_kernel(Params a, float* __restrict__ part_acc,
                float* __restrict__ part_ml) {
  extern __shared__ float smem[];
  const int G = a.H / a.KvH;
  const int kvh = blockIdx.x, blk = blockIdx.y, b = blockIdx.z;
  const int run = b * a.nblk + blk;
  const int qp = a.lengths[b];
  const int k_start = blk * a.ps;
  bool needed = k_start <= qp;
  if (a.window > 0) needed = needed && (k_start + a.ps - 1 > qp - a.window);
  if (!needed) {
    if (threadIdx.x < G) {
      const int64_t e = ((int64_t)run * a.KvH + kvh) * G + threadIdx.x;
      part_ml[e * 2] = NEG_INF;
      part_ml[e * 2 + 1] = 0.f;
    }
    return;
  }
  const Smem sm(smem, G, a.hd, a.ps, sizeof(T));
  load_q(a, sm, G, b, kvh);
  State st;
  init_state(st);
  page_update<T, QUANT, PACK4>(a, sm, st, G, b, kvh, blk, qp);
  store_partial(a, st, G, run, kvh, part_acc, part_ml);
}

template <typename T, bool QUANT, bool PACK4>
int launch(const Params& a, float* part_acc, float* part_ml, void* stream) {
  static size_t granted = 48 << 10;
  const size_t smem =
      sizeof(float) * smem_floats(a.H / a.KvH, a.hd, a.ps, sizeof(T));
  allow_smem(paged_v2_kernel<T, QUANT, PACK4>, smem, granted);
  paged_v2_kernel<T, QUANT, PACK4>
      <<<dim3(a.KvH, a.nblk, a.B), NTHREADS, smem, (cudaStream_t)stream>>>(
          a, part_acc, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_partials<false><<<dim3(a.KvH, a.B), NTHREADS, 0,
                          (cudaStream_t)stream>>>(a, 1, part_acc, part_ml);
  return (int)cudaGetLastError();
}

}  // namespace

// Arguments as paged_decode.cu's entries, plus the partials' scratch:
// part_acc [B * nblk, KvH, H / KvH, hd] and part_ml [B * nblk, KvH,
// H / KvH, 2] f32. Attends blocks [0, nblk) of each slot's table (nblk <=
// NBLK, the table's width). Two launches on ``stream``: partials, merge.
// Returns cudaGetLastError().
#define PAGED_V2_ENTRY(NAME, T, QUANT, PACK4)                                \
  extern "C" int NAME(const void* q, const void* kq, const void* ks,        \
                      const void* vq, const void* vs, const int* tables,    \
                      const int* lengths, void* out, void* part_acc,        \
                      void* part_ml, int B, int H, int KvH, int hd, int P,  \
                      int ps, int NBLK, int nblk, int layer, float scale,   \
                      float softcap, int window, void* stream) {            \
    if (PACK4 && ps % 2) return (int)cudaErrorInvalidValue;                 \
    return launch<T, QUANT, PACK4>(                                          \
        make_params(q, kq, ks, vq, vs, tables, lengths, out, B, H, KvH, hd, \
                    P, ps, NBLK, nblk, layer, scale, softcap, window),      \
        (float*)part_acc, (float*)part_ml, stream);                          \
  }

PAGED_V2_ENTRY(paged_decode_v2_int8, int8_t, true, false)
PAGED_V2_ENTRY(paged_decode_v2_int4, int8_t, true, true)
PAGED_V2_ENTRY(paged_decode_v2_bf16, __nv_bfloat16, false, false)
