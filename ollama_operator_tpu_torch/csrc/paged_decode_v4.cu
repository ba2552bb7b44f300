// Single-token GQA attention over the paged KV pool on a flat grid over
// the live pages, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/paged.py ::
// paged_decode_attention_v4 (body _paged_kernel_v4): one grid step per
// page of the slot-sorted list of live pages (built by cumsum and
// searchsorted over min(len / ps + 1, nblk)), the softmax state carried
// across one slot's consecutive pages and reset at slot boundaries. Its
// contract: keys in the first ``nblk`` blocks of the table only. The
// function, the per-page code and the pool layout are in paged_common.cuh,
// shared with the v2 and v3 kernels.
//
// What bounds it on the card: bytes, as for the v3 kernel, plus one
// partial (G * hd + 2 f32) per run of pages written and read back once.
//
// Design. The v4 formulation exists so that no program carries the longest
// slot's whole chain of pages while the others idle. Here a fixed number of
// CTAs per kv head (``chunks``, from the wrapper) each take an equal share
// of the flat list of live pages: chunk = ceil(total / chunks) consecutive
// list entries. The list is built on the device with no host sync: every
// CTA scans the slots' page counts in shared memory (B <= 1024) and
// binary-searches the slot of its first entry. A CTA carries its softmax
// state across consecutive pages of one slot and stores a partial (m, l,
// acc) at each slot boundary and at the end of its share; a second launch
// merges each (kv head, slot)'s partials in list order
// (merge_partials<true>), so a repeat gives the same bits. The list holds a
// slot's pages from the window's first block: v4 lists the pages before it
// too and masks them, and such a page changes neither the running max nor
// the sums.

#include "paged_common.cuh"

namespace {

using namespace paged;

template <typename T, bool QUANT, bool PACK4>
__global__ void __launch_bounds__(NTHREADS)
paged_v4_kernel(Params a, int chunks, float* __restrict__ part_acc,
                float* __restrict__ part_ml) {
  extern __shared__ float smem[];
  const int G = a.H / a.KvH;
  const Smem sm(smem, G, a.hd, a.ps, sizeof(T));
  int* first = (int*)sm.end;  // [B]
  int* ends = first + a.B;    // [B]
  const int c = blockIdx.x, kvh = blockIdx.y;
  build_slot_list(a, first, ends);
  const int total = ends[a.B - 1];
  const int chunk = (total + chunks - 1) / chunks;
  const int n0 = c * chunk;
  const int n1 = min(n0 + chunk, total);
  if (n0 >= n1) return;
  // the slot of entry n0: the first b with ends[b] > n0
  int lo = 0, hi = a.B - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (ends[mid] > n0) hi = mid;
    else lo = mid + 1;
  }
  int b = lo;
  int run = n0;
  load_q(a, sm, G, b, kvh);
  State st;
  init_state(st);
  for (int n = n0; n < n1; ++n) {
    const int slot_start = b ? ends[b - 1] : 0;
    page_update<T, QUANT, PACK4>(a, sm, st, G, b, kvh,
                                 first[b] + (n - slot_start), a.lengths[b]);
    if (n + 1 == ends[b] || n + 1 == n1) {
      store_partial(a, st, G, run, kvh, part_acc, part_ml);
      if (n + 1 < n1) {
        while (ends[b] <= n + 1) ++b;
        run = n + 1;
        load_q(a, sm, G, b, kvh);
        init_state(st);
      }
    }
  }
}

template <typename T, bool QUANT, bool PACK4>
int launch(const Params& a, int chunks, float* part_acc, float* part_ml,
           void* stream) {
  static size_t granted = 48 << 10;
  const size_t smem =
      sizeof(float) * smem_floats(a.H / a.KvH, a.hd, a.ps, sizeof(T)) +
      2 * sizeof(int) * (size_t)a.B;
  allow_smem(paged_v4_kernel<T, QUANT, PACK4>, smem, granted);
  paged_v4_kernel<T, QUANT, PACK4>
      <<<dim3(chunks, a.KvH), NTHREADS, smem, (cudaStream_t)stream>>>(
          a, chunks, part_acc, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_partials<true>
      <<<dim3(a.KvH, a.B), NTHREADS, 2 * sizeof(int) * (size_t)a.B,
         (cudaStream_t)stream>>>(a, chunks, part_acc, part_ml);
  return (int)cudaGetLastError();
}

}  // namespace

// Arguments as paged_decode_v2.cu's entries, plus ``chunks``, the number of
// CTAs per kv head that share the flat list (>= 1). B <= 1024 (the slot
// list lives in shared memory). Two launches on ``stream``: partials,
// merge. Returns cudaGetLastError().
#define PAGED_V4_ENTRY(NAME, T, QUANT, PACK4)                                \
  extern "C" int NAME(const void* q, const void* kq, const void* ks,        \
                      const void* vq, const void* vs, const int* tables,    \
                      const int* lengths, void* out, void* part_acc,        \
                      void* part_ml, int B, int H, int KvH, int hd, int P,  \
                      int ps, int NBLK, int nblk, int layer, float scale,   \
                      float softcap, int window, int chunks, void* stream) { \
    if ((PACK4 && ps % 2) || chunks < 1 || B > 1024)                        \
      return (int)cudaErrorInvalidValue;                                     \
    return launch<T, QUANT, PACK4>(                                          \
        make_params(q, kq, ks, vq, vs, tables, lengths, out, B, H, KvH, hd, \
                    P, ps, NBLK, nblk, layer, scale, softcap, window),      \
        chunks, (float*)part_acc, (float*)part_ml, stream);                  \
  }

PAGED_V4_ENTRY(paged_decode_v4_int8, int8_t, true, false)
PAGED_V4_ENTRY(paged_decode_v4_int4, int8_t, true, true)
PAGED_V4_ENTRY(paged_decode_v4_bf16, __nv_bfloat16, false, false)
