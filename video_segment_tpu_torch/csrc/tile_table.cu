// Supertile-table merge rounds (K3) for Hopper (sm_90a).
//
// Replaces: video_segment_tpu/ops/tile_table.py, `tile_table_rounds`
// (Pallas `_kernel`).  One launch runs one gated schedule level's Boruvka
// rounds over every supertile's blocked slot table: region statistics of
// the current labels, each region's best admissible (bucket, partner root)
// over its slots' top-K same-supertile edges (mean-colour gate with the
// force-merge shortcut, finalize and blocked gates), hooking by alternating
// parity, pointer jumping to roots.  On the TPU every per-label reduction
// and gather was a one-hot MXU contraction over the (SR,128) slot grid,
// because the TPU has no scatter.
//
// What bounds it here: the dependent phases of each round (a handful of
// block barriers plus the pointer-jump passes), not memory (the bound is
// the edge and seed planes read once).  A supertile stays resident in one
// CTA of up to 1024 threads, each owning up to four slots; its per-label
// tables live in dynamic shared memory, 56 bytes a slot (224 KB at 4096
// slots): float64 sums of size and colour, float32 means, the finalize
// minimum, the best-candidate / parent table and the slot labels.  The
// design keeps each round short:
//  - the sums are aggregated once per launch (a slot that is its own label
//    stores its statistics, the others add theirs) and then move with the
//    merges: after the pointer jump every label that moved adds its sums to
//    its new root, instead of four float64 atomics per slot and round (the
//    card has no shared-memory float64 add: each is a compare-and-swap
//    loop);
//  - a label's float32 mean is divided when its sums change, not per
//    tested edge;
//  - a blocked region never merges, so it is a finalize minimum of 0 (no
//    bucket is below it), and no blocked flag is read;
//  - a live-edge mask per slot in registers: an edge that is absent, above
//    `theta`, at or above a finalize minimum (minima only fall) or inside
//    one region (regions only merge) stays dead for the launch, so later
//    rounds skip its load.
// Exactness: the plain version sums the seeds of each region in float64
// every round; float64 sums of the seeds' float32 statistics are exact (the
// invariant the kernel relied on before this design too), so carrying them
// gives the same sums, and the means are rounded exactly as the plain
// version rounds them (float32 sum over the float32 size clamped to 1).
// Distances use the JAX formula with round-to-nearest intrinsics (built
// with -fmad=false).  The pointer jump runs in place to a fixed point
// tested with __syncthreads_or.

#include <cuda_runtime.h>

#include <climits>

// Must match `_Params` in ops/tile_table.py.
struct TableParams {
  int theta;
  int rounds;
  int metric_l1;
  float merge_threshold;
  float force_merge_weight;
};

namespace {

constexpr int L = 128;
constexpr int PBITS = 12;
constexpr int PMASK = (1 << PBITS) - 1;
constexpr int MAX_SLOTS = 1 << PBITS;
constexpr int MAX_K = 32;             // bits of the live-edge mask
constexpr int THREADS = 1024;
constexpr int PER_THREAD = MAX_SLOTS / THREADS;
constexpr int SLOT_BYTES = 4 * sizeof(double) + 3 * sizeof(float) +
                           3 * sizeof(int);

__device__ __forceinline__ float dist32(float a0, float a1, float a2,
                                        float b0, float b1, float b2,
                                        bool l1) {
  const float d0 = __fsub_rn(a0, b0);
  const float d1 = __fsub_rn(a1, b1);
  const float d2 = __fsub_rn(a2, b2);
  if (l1) {
    return __fmul_rn(__fadd_rn(__fadd_rn(fabsf(d0), fabsf(d1)), fabsf(d2)),
                     1.0f / 3.0f);
  }
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                             __fmul_rn(d2, d2));
  return __fsqrt_rn(__fmul_rn(ss, 1.0f / 3.0f));
}

// Slot j's scan: its best admissible packed (bucket, partner root) over
// its live edges (bits of m), clearing the bits of edges found dead.
__device__ __forceinline__ int scan_slot(const int* __restrict__ edg, int j,
                                         int S, unsigned& m, int own,
                                         const int* lab, const int* fin_t,
                                         const float* m0, const float* m1,
                                         const float* m2,
                                         const TableParams& prm, bool l1) {
  const int ofin = fin_t[own];
  const float om0 = m0[own], om1 = m1[own], om2 = m2[own];
  int best = INT_MAX;
  for (unsigned rest = m; rest != 0; rest &= rest - 1) {
    const int k = __ffs(rest) - 1;
    const int e = edg[(long long)k * S + j];
    const int b = e >> PBITS;
    const int nb = lab[min(e & PMASK, S - 1)];
    if (b >= ofin || nb == own || b >= fin_t[nb]) {
      m &= ~(1u << k);                 // dead for the rest of the launch
      continue;
    }
    float d = dist32(om0, om1, om2, m0[nb], m1[nb], m2[nb], l1);
    const float w_eff = __fmul_rn((float)b, 1.0f / 2048.0f);
    if (w_eff < prm.force_merge_weight && d < 0.2f) d = 0.0f;
    if (d < prm.merge_threshold) best = min(best, (b << PBITS) | nb);
  }
  return best;
}

// Slot j's edges that are present and at most theta, as a bit mask.
__device__ __forceinline__ unsigned live_edges(const int* __restrict__ edg,
                                               int j, int S, int K,
                                               int theta) {
  unsigned m = 0;
  for (int k = 0; k < K; ++k) {
    const int e = edg[(long long)k * S + j];
    if (e != INT_MAX && (e >> PBITS) <= theta) m |= 1u << k;
  }
  return m;
}

__global__ void __launch_bounds__(THREADS)
tile_table_kernel(const int* __restrict__ labr, const int* __restrict__ labc,
                  const float* __restrict__ size,
                  const float* __restrict__ c0, const float* __restrict__ c1,
                  const float* __restrict__ c2, const int* __restrict__ fin,
                  const int* __restrict__ blocked,
                  const int* __restrict__ edges, int* __restrict__ outr,
                  int* __restrict__ outc, int S, int K, TableParams prm) {
  extern __shared__ double smem[];
  double* s_size = smem;               // [S] per-label sums (float64)
  double* s_c0 = s_size + S;
  double* s_c1 = s_c0 + S;
  double* s_c2 = s_c1 + S;
  float* m0 = (float*)(s_c2 + S);      // [S] per-label means (float32;
  float* m1 = m0 + S;                  // NaN in m0: sums changed)
  float* m2 = m1 + S;
  int* fin_t = (int*)(m2 + S);         // [S] finalize minimum (0: blocked)
  int* par = fin_t + S;                // [S] best candidate, then parent
  int* lab = par + S;                  // [S] current root per slot

  const long long base = (long long)blockIdx.x * S;
  const int* edg = edges + base * K;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const bool l1 = prm.metric_l1 != 0;
  const float stale = __int_as_float(0x7fffffff);

  // -- phase: the seed statistics summed by label.  A slot that is its own
  // label stores its statistics; the others then add theirs atomically.
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int j = tid + q * nth;
    if (j >= S) break;
    const int l = labr[base + j] * L + labc[base + j];
    const bool own = l == j;
    lab[j] = l;
    s_size[j] = own ? (double)size[base + j] : 0.0;
    s_c0[j] = own ? (double)c0[base + j] : 0.0;
    s_c1[j] = own ? (double)c1[base + j] : 0.0;
    s_c2[j] = own ? (double)c2[base + j] : 0.0;
    fin_t[j] = own ? fin[base + j] : INT_MAX;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int j = tid + q * nth;
    if (j >= S) break;
    const int l = lab[j];
    if (l != j) {
      atomicAdd(&s_size[l], (double)size[base + j]);
      atomicAdd(&s_c0[l], (double)c0[base + j]);
      atomicAdd(&s_c1[l], (double)c1[base + j]);
      atomicAdd(&s_c2[l], (double)c2[base + j]);
      atomicMin(&fin_t[l], fin[base + j]);
    }
    // A blocked region never merges: its minimum becomes 0, below every
    // bucket (only labels in use are ever read).
    if (blocked[base + j]) atomicMin(&fin_t[j], 0);
  }
  __syncthreads();

  // Live-edge masks, bit k of slot (tid + q * nth).
  unsigned live[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int j = tid + q * nth;
    live[q] = j < S ? live_edges(edg, j, S, K, prm.theta) : 0u;
  }

  int idle = 0;
  for (int i = 0; i < prm.rounds && idle < 2; ++i) {
    // -- phase: means of the sums that changed; clear the candidates.
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int l = tid + q * nth;
      if (l >= S) break;
      if (i == 0 || isnan(m0[l])) {
        const float den = fmaxf((float)s_size[l], 1.0f);
        m0[l] = __fdiv_rn((float)s_c0[l], den);
        m1[l] = __fdiv_rn((float)s_c1[l], den);
        m2[l] = __fdiv_rn((float)s_c2[l], den);
      }
      par[l] = INT_MAX;
    }
    __syncthreads();

    // -- phase: best admissible packed (bucket, partner root) per slot,
    // min-reduced into its region's entry of `par`.
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      if (live[q] == 0) continue;
      const int j = tid + q * nth;
      const int own = lab[j];
      const int best = scan_slot(edg, j, S, live[q], own, lab, fin_t, m0,
                                 m1, m2, prm, l1);
      if (best != INT_MAX) atomicMin(&par[own], best);
    }
    __syncthreads();

    // -- phase: parity hooking of region roots onto their best partners.
    const bool up = (i % 2) == 0;
    bool have_any = false;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int l = tid + q * nth;
      if (l >= S) break;
      const int bt = par[l];
      const bool have = bt != INT_MAX;
      const int pt = bt & PMASK;
      have_any |= have;
      par[l] = (have && ((pt > l) == up)) ? pt : l;
    }
    const bool nhave = __syncthreads_or(have_any);

    // -- phase: pointer jumping in place; every write replaces a parent by
    // one of its ancestors, so any interleaving reaches the same roots.
    for (;;) {
      bool changed = false;
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) {
        const int l = tid + q * nth;
        if (l >= S) break;
        const int p = par[l];
        const int pp = par[p];
        if (pp != p) {
          par[l] = pp;
          changed = true;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }

    // -- phase: relabel the slots; every label that moved adds its sums
    // and finalize minimum to its root and marks the root's mean stale (a
    // root never moves, and a label that moved is read only here, so the
    // adds race with nothing).
    bool moved_any = false;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int j = tid + q * nth;
      if (j >= S) break;
      const int r = par[j];
      if (r != j) {
        atomicAdd(&s_size[r], s_size[j]);
        atomicAdd(&s_c0[r], s_c0[j]);
        atomicAdd(&s_c1[r], s_c1[j]);
        atomicAdd(&s_c2[r], s_c2[j]);
        atomicMin(&fin_t[r], fin_t[j]);
        m0[r] = stale;
      }
      const int nl = par[lab[j]];
      moved_any |= nl != lab[j];
      lab[j] = nl;
    }
    const bool moved = __syncthreads_or(moved_any);
    idle = !nhave ? 2 : (moved ? 0 : idle + 1);
  }

#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int j = tid + q * nth;
    if (j >= S) break;
    outr[base + j] = lab[j] / L;
    outc[base + j] = lab[j] % L;
  }
}

}  // namespace

extern "C" int tile_table_launch(const void* labr, const void* labc,
                                 const void* size, const void* c0,
                                 const void* c1, const void* c2,
                                 const void* fin, const void* blocked,
                                 const void* edges, void* outr, void* outc,
                                 int N, int SR, int K, const TableParams* prm,
                                 void* stream) {
  const int S = SR * L;
  if (N <= 0 || SR <= 0) return 0;
  if (S > MAX_SLOTS || K < 0 || K > MAX_K) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * SLOT_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      tile_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = S < THREADS ? S : THREADS;
  tile_table_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const int*)labr, (const int*)labc, (const float*)size,
      (const float*)c0, (const float*)c1, (const float*)c2, (const int*)fin,
      (const int*)blocked, (const int*)edges, (int*)outr, (int*)outc, S, K,
      *prm);
  return (int)cudaGetLastError();
}

// out: registers a thread, local (spill) bytes a thread, static and
// dynamic shared memory bytes a CTA, threads a CTA, resident CTAs an SM.
extern "C" int tile_table_resources(int* out) {
  const int smem = MAX_SLOTS * SLOT_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      tile_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, tile_table_kernel);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, tile_table_kernel,
                                                    THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = smem;
  out[4] = THREADS;
  out[5] = ctas;
  return 0;
}
