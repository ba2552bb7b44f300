// Single-token GQA attention over the first ``nblk`` blocks of the paged KV
// pool on a flat list of live work, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/paged.py ::
// paged_decode_attention_v4 (body _paged_kernel_v4): one grid step per
// page of the slot-sorted list of live pages (built by cumsum and
// searchsorted over min(len / ps + 1, nblk)), the softmax state carried
// across one slot's consecutive pages and reset at slot boundaries. Its
// contract: keys in the first ``nblk`` blocks of the table only. The
// function and the pool layout are in paged_common.cuh, shared with the v2
// and v3 kernels.
//
// What bounds it on the card: bytes, as for the v3 kernel, plus one
// partial (G * hd + 2 f32) per run of tiles written and read back once.
//
// Design. The v4 formulation exists so that no program carries the longest
// slot's whole chain while the others idle. Here the list's unit is the v3
// kernel's chunk: the live rows of one slot inside one run of
// ``chunk_pages`` table blocks (chunk_rows of paged_tiles.cuh), at most 512
// positions of 32-position tiles. Slot b's units are the chunks from its
// window's first row to min(lengths[b], nblk * ps - 1); v4 lists the pages
// before the window too and masks them, and such a page changes neither
// the running max nor the sums. A fixed number of CTAs per kv head
// (``chunks``, from the wrapper) each take an equal share of the flat list
// of live units, ceil(total / chunks) consecutive entries. The list is
// built on the device with no host sync: every CTA scans the slots' unit
// counts in shared memory (a block scan, B <= 1024) and finds each unit's
// slot by a binary search. The CTA's warps fold each unit of its share on
// the v3 kernel's tile loop (paged_tiles.cuh fold_tiles: cp.async rings a
// warp, S^T = K . Q^T and O^T += V^T . P^T on mma.sync) into the partial
// (m, l, acc) of run n, its place in the list. A unit is folded whole by
// one CTA, as the v3 kernel folds a chunk, so a slot's partials and their
// bits do not depend on the other slots: a finer unit (32-position tiles,
// shares cut inside a slot) made a slot's bits depend on where the other
// slots put the share boundaries, and a greedy stream on path 8 of
// chip_smoke.py changed when its prompt was repeated alone (PERF.md). A
// slot's runs are consecutive in the list; CTA (0, 0) writes each slot's
// first run and run count, and a second launch (merge_v4,
// split_decode.cuh merge_run) merges each (kv head, slot, query row)'s
// runs in list order with their (m, l) staged in shared memory, so a
// repeat gives the same bits (and the v3 kernel's, over the first nblk
// blocks). At hd not a multiple of 16 the CTA folds each unit with the
// scalar page loop (paged_common.cuh page_update) into the same partials.

#include "paged_tiles.cuh"

namespace {

// The units of slot b: the chunks of cp blocks that hold its live rows
// within the first nblk blocks, from z0 on; 0 for a slot with no live row.
__device__ __forceinline__ int slot_units(const Params& a, int cp, int b,
                                          int& z0) {
  int lo, hi;
  if (!chunk_rows(a, a.lengths[b], 0, 0, lo, hi)) return 0;
  const int rows = cp * a.ps;
  z0 = lo / rows;
  return hi / rows - z0 + 1;
}

// The flat list in shared memory: ends[b] = the units of slots 0..b (an
// inclusive prefix sum over the CTA: each thread sums a run of consecutive
// slots, the warps scan those sums with shuffles, wsum [4] carries the
// warps' totals). Every thread returns after it is built.
__device__ __forceinline__ void build_list(const Params& a, int cp,
                                           int* ends, int* wsum) {
  const int per = (a.B + blockDim.x - 1) / blockDim.x;
  const int b0 = threadIdx.x * per;
  int sum = 0;
  for (int i = 0; i < per; ++i) {
    const int b = b0 + i;
    if (b < a.B) {
      int z0;
      sum += slot_units(a, cp, b, z0);
      ends[b] = sum;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int off = x - sum;
  for (int w = 0; w < warp; ++w) off += wsum[w];
  for (int i = 0; i < per; ++i)
    if (b0 + i < a.B) ends[b0 + i] += off;
  __syncthreads();
}

// CTA (kv head, c)'s share of the list: units [n0, n1) of ceil(total /
// chunks) a CTA. CTA (0, 0) also writes runs[2b] (slot b's first run: its
// first unit's place in the list) and runs[2b + 1] (its unit count).
__device__ __forceinline__ void share(const Params& a, int chunks,
                                      const int* ends, int* runs, int& n0,
                                      int& n1) {
  const int total = ends[a.B - 1];
  const int per = (total + chunks - 1) / chunks;
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
      const int s = b ? ends[b - 1] : 0;
      runs[2 * b] = s;
      runs[2 * b + 1] = ends[b] - s;
    }
  }
  n0 = blockIdx.y * per;
  n1 = min(n0 + per, total);
}

// Unit n of the list: its slot b (the first b with ends[b] > n) and the
// chunk z of that slot it is.
__device__ __forceinline__ int unit_of(const Params& a, int cp,
                                      const int* ends, int n, int& z) {
  int bl = 0, bh = a.B - 1;
  while (bl < bh) {
    const int mid = (bl + bh) / 2;
    if (ends[mid] > n) bh = mid;
    else bl = mid + 1;
  }
  int z0;
  slot_units(a, cp, bl, z0);
  z = z0 + n - (bl ? ends[bl - 1] : 0);
  return bl;
}

// Ints of the list in shared memory: ends [B], the warps' sums [4].
inline size_t list_bytes(int B) { return sizeof(int) * ((size_t)B + 4); }

// hd a multiple of 16 up to MAXHD: grid (KvH, chunks) of nw-warp CTAs,
// the kv head fastest, as the v3 kernel's grid, so CTAs that run together
// read one unit's pages for every kv head (a page holds them side by
// side); shared memory: the rings (mma_smem_bytes), then at ``list_off``
// the list. (At least 3 CTAs a SM, the int8 pool's rings at hd 128 allow
// no more: with no bound ptxas (CUDA 12.8) held the int4 and the bf16
// instantiations at 96 registers and spilled 8 to 12 bytes.)
template <int MAXHD, int POOL>
__global__ void __launch_bounds__(128, 3)
paged_v4_mma_kernel(Params a, int cp, int chunks, int list_off,
                    int* __restrict__ runs, float* __restrict__ part_acc,
                    float* __restrict__ part_ml) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ends = (int*)(smem + list_off);
  build_list(a, cp, ends, ends + a.B);
  int n0, n1;
  share(a, chunks, ends, runs, n0, n1);
  const int G = a.H / a.KvH, kvh = blockIdx.x;
  for (int n = n0; n < n1; ++n) {
    __syncthreads();  // the last unit's reads of the rings are over
    int z, lo, hi;
    const int b = unit_of(a, cp, ends, n, z);
    chunk_rows(a, a.lengths[b], cp, z, lo, hi);
    const int T0 = lo & ~(TILE - 1);
    fold_tiles<MAXHD, POOL>(a, b, kvh, lo, hi, T0, (hi - T0) / TILE + 1,
                            ((int64_t)n * a.KvH + kvh) * G, part_acc,
                            part_ml, smem);
  }
}

// Other head dims: each unit folded with the scalar page loop. (At least 4
// CTAs a SM, as the v3 kernel's scalar loop: ptxas otherwise spills across
// the page loop's division calls.)
template <typename T, bool QUANT, bool PACK4>
__global__ void __launch_bounds__(NTHREADS, 4)
paged_v4_scalar_kernel(Params a, int cp, int chunks, int list_off,
                       int* __restrict__ runs, float* __restrict__ part_acc,
                       float* __restrict__ part_ml) {
  extern __shared__ float fsmem[];
  int* ends = (int*)((unsigned char*)fsmem + list_off);
  build_list(a, cp, ends, ends + a.B);
  int n0, n1;
  share(a, chunks, ends, runs, n0, n1);
  const int G = a.H / a.KvH, kvh = blockIdx.x;
  const Smem sm(fsmem, G, a.hd, a.ps, sizeof(T));
  for (int n = n0; n < n1; ++n) {
    int z, lo, hi;
    const int b = unit_of(a, cp, ends, n, z);
    const int qp = a.lengths[b];
    chunk_rows(a, qp, cp, z, lo, hi);
    load_q(a, sm, G, b, kvh);
    State st;
    init_state(st);
    for (int i = lo / a.ps; i <= hi / a.ps; ++i)
      page_update<T, QUANT, PACK4>(a, sm, st, G, b, kvh, i, qp);
    store_partial(a, st, G, n, kvh, part_acc, part_ml);
  }
}

// Second launch: one CTA per (kv head, slot, query row of the group)
// merges the slot's runs runs[2b] .. runs[2b] + runs[2b + 1] - 1 in list
// order; a slot with none writes 0.
__global__ void __launch_bounds__(128)
merge_v4(const float* __restrict__ part_acc,
         const float* __restrict__ part_ml, const int* __restrict__ runs,
         __nv_bfloat16* __restrict__ out, int H, int KvH, int hd) {
  extern __shared__ float ml[];  // [runs of the slot][2]
  const int kvh = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int G = H / KvH;
  split::merge_run(part_acc, part_ml,
                   out + ((int64_t)b * H + kvh * G + g) * hd,
                   ((int64_t)runs[2 * b] * KvH + kvh) * G + g,
                   (int64_t)KvH * G, runs[2 * b + 1], hd, ml);
}

template <int MAXHD, int POOL>
int launch_v4_mma(const Params& a, int cp, int chunks, int* runs,
                  float* part_acc, float* part_ml, cudaStream_t s) {
  static size_t granted = 48 << 10;
  int nw = mma_warps<POOL>(a.hd);
  if (mma_smem_bytes<POOL>(a.hd, nw) + list_bytes(a.B) > (size_t)MAX_SMEM)
    nw = 2;  // four rings and a long list do not fit (bf16, hd 208)
  const size_t off = mma_smem_bytes<POOL>(a.hd, nw);
  const size_t smem = off + list_bytes(a.B);
  allow_smem(paged_v4_mma_kernel<MAXHD, POOL>, smem, granted);
  paged_v4_mma_kernel<MAXHD, POOL><<<dim3(a.KvH, chunks), 32 * nw, smem,
                                     s>>>(a, cp, chunks, (int)off, runs,
                                          part_acc, part_ml);
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT, bool PACK4>
int launch_v4(const Params& a, int cp, int chunks, int* runs,
              float* part_acc, float* part_ml, cudaStream_t s) {
  constexpr int POOL = !QUANT ? BF16 : PACK4 ? INT4 : INT8;
  const int G = a.H / a.KvH;
  int rc;
  if (paged_tensor_cores(a.hd)) {
    rc = a.hd <= 128 ? launch_v4_mma<128, POOL>(a, cp, chunks, runs,
                                                part_acc, part_ml, s)
                     : launch_v4_mma<256, POOL>(a, cp, chunks, runs,
                                                part_acc, part_ml, s);
  } else {
    static size_t granted = 48 << 10;
    const size_t off = sizeof(float) * smem_floats(G, a.hd, a.ps, sizeof(T));
    const size_t smem = off + list_bytes(a.B);
    allow_smem(paged_v4_scalar_kernel<T, QUANT, PACK4>, smem, granted);
    paged_v4_scalar_kernel<T, QUANT, PACK4>
        <<<dim3(a.KvH, chunks), NTHREADS, smem, s>>>(
            a, cp, chunks, (int)off, runs, part_acc, part_ml);
    rc = (int)cudaGetLastError();
  }
  if (rc) return rc;
  // a slot has at most ceil(nblk / cp) units
  const size_t ml = sizeof(float) * 2 * ((a.nblk + cp - 1) / cp);
  merge_v4<<<dim3(a.KvH, a.B, G), 128, ml, s>>>(part_acc, part_ml, runs,
                                                a.out, a.H, a.KvH, a.hd);
  return (int)cudaGetLastError();
}

}  // namespace

// Arguments as paged_decode_v2.cu's entries, with ``chunks`` (>= 1, the
// CTAs per kv head that share the flat list) after ``chunk_pages`` (> 0,
// the blocks of a unit): part_acc [B * nunit, KvH, H / KvH, hd] and
// part_ml [B * nunit, KvH, H / KvH, 2] f32, nunit = ceil(nblk /
// chunk_pages), the partials of the runs (one a live unit), and right
// after part_ml [B, 2] int32, each slot's first run and run count. B <=
// 1024 (the list lives in shared memory); the merge stages a slot's runs
// in at most 48 KB (nunit <= 6144). Two launches on ``stream`` (partials,
// merge). Returns cudaGetLastError() (cudaErrorInvalidValue, and no
// launch, for a shape, width or count it does not take).
#define PAGED_V4_ENTRY(NAME, T, QUANT, PACK4)                                \
  extern "C" int NAME(const void* q, const void* kq, const void* ks,        \
                      const void* vq, const void* vs, const int* tables,    \
                      const int* lengths, void* out, void* part_acc,        \
                      void* part_ml, int B, int H, int KvH, int hd, int P,  \
                      int ps, int NBLK, int nblk, int layer, float scale,   \
                      float softcap, int window, int chunk_pages,           \
                      int chunks, void* stream) {                           \
    if (!paged_shape_ok(B, H, KvH, hd, ps, PACK4, NBLK, nblk) ||            \
        B > 1024 || chunk_pages <= 0 || chunks < 1 ||                       \
        (nblk + chunk_pages - 1) / chunk_pages > 6144)                      \
      return (int)cudaErrorInvalidValue;                                    \
    const int64_t n_runs =                                                  \
        (int64_t)B * ((nblk + chunk_pages - 1) / chunk_pages);              \
    int* runs = (int*)((float*)part_ml + n_runs * H * 2);                   \
    return launch_v4<T, QUANT, PACK4>(                                       \
        make_params(q, kq, ks, vq, vs, tables, lengths, out, B, H, KvH, hd, \
                    P, ps, NBLK, nblk, layer, scale, softcap, window),      \
        chunk_pages, chunks, runs, (float*)part_acc, (float*)part_ml,       \
        (cudaStream_t)stream);                                              \
  }

PAGED_V4_ENTRY(paged_decode_v4_int8, int8_t, true, false)
PAGED_V4_ENTRY(paged_decode_v4_int4, int8_t, true, true)
PAGED_V4_ENTRY(paged_decode_v4_bf16, __nv_bfloat16, false, false)

// 1 when the entries run head dim ``hd`` on the tensor cores, 0 when they
// take the scalar page loop.
extern "C" int paged_decode_v4_tensor_cores(int hd) {
  return paged_tensor_cores(hd);
}
