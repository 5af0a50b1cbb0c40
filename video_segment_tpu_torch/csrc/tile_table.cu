// Supertile-table merge rounds (K3) for Hopper (sm_90a).
//
// Replaces: video_segment_tpu/ops/tile_table.py, `tile_table_rounds`
// (Pallas `_kernel`).  One launch runs one gated schedule level's Boruvka
// rounds over every supertile's blocked slot table: re-aggregate the
// region statistics from the seed slots, pick each region's best
// admissible (bucket, partner root) over its slots' top-K same-supertile
// edges (mean-colour gate with the force-merge shortcut, finalize and
// blocked gates), hook by alternating parity, pointer-jump to roots.  On
// the TPU every per-label reduction and gather was a one-hot MXU
// contraction over the (SR,128) slot grid, because the TPU has no scatter.
//
// What bounds it here: the latency of the dependent phases of each round
// (about ten block barriers plus the pointer-jump fixed point) and the
// per-round re-read of the edge planes (K x 16 KB per supertile from L2 /
// device memory).  The design keeps a supertile resident in one CTA of up
// to 1024 threads, each owning up to four slots: slot labels, the hooking
// table (which doubles as the per-label best-candidate table), per-label
// finalize minima and float64 sums of size and colour live in dynamic shared
// memory (44 bytes a slot: 176 KB at 4096 slots, under the 227 KB a block
// may opt into).  Seed statistics stay in registers; edges and the blocked
// flags are read from device memory.  Region means are computed where they
// are needed from the float64 sums (rounded to float32, then divided):
// float64 sums of the seeds' float32 statistics do not depend on the
// atomics' order in practice, so the kernel equals its plain PyTorch
// version bit for bit.  Distances use the JAX formula with round-to-nearest
// intrinsics (built with -fmad=false).  The pointer jump runs in place to a
// fixed point tested with __syncthreads_or.

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
constexpr int THREADS = 1024;
constexpr int PER_THREAD = MAX_SLOTS / THREADS;

__device__ __forceinline__ float label_mean(const double* sum,
                                            const double* size, int l) {
  const float den = fmaxf((float)size[l], 1.0f);
  return __fdiv_rn((float)sum[l], den);
}

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
  int* lab = (int*)(s_c2 + S);         // [S] current root per slot
  int* par = lab + S;                  // [S] best candidate, then parent
  int* fin_t = par + S;                // [S] per-label finalize minimum

  const long long base = (long long)blockIdx.x * S;
  const int* blk = blocked + base;
  const int* edg = edges + base * K;
  const int tid = threadIdx.x;
  const bool l1 = prm.metric_l1 != 0;

  // Seed statistics of this thread's slots, kept in registers.
  float sz[PER_THREAD], a0[PER_THREAD], a1[PER_THREAD], a2[PER_THREAD];
  int fn[PER_THREAD];
  for (int q = 0; q < PER_THREAD; ++q) {
    const int j = tid + q * blockDim.x;
    if (j < S) {
      sz[q] = size[base + j];
      a0[q] = c0[base + j];
      a1[q] = c1[base + j];
      a2[q] = c2[base + j];
      fn[q] = fin[base + j];
      lab[j] = labr[base + j] * L + labc[base + j];
    }
  }
  __syncthreads();

  int idle = 0;
  for (int i = 0; i < prm.rounds && idle < 2; ++i) {
    for (int j = tid; j < S; j += blockDim.x) {
      s_size[j] = 0.0;
      s_c0[j] = 0.0;
      s_c1[j] = 0.0;
      s_c2[j] = 0.0;
      fin_t[j] = INT_MAX;
      par[j] = INT_MAX;
    }
    __syncthreads();
    for (int q = 0; q < PER_THREAD; ++q) {
      const int j = tid + q * blockDim.x;
      if (j < S) {
        const int l = lab[j];
        atomicAdd(&s_size[l], (double)sz[q]);
        atomicAdd(&s_c0[l], (double)a0[q]);
        atomicAdd(&s_c1[l], (double)a1[q]);
        atomicAdd(&s_c2[l], (double)a2[q]);
        atomicMin(&fin_t[l], fn[q]);
      }
    }
    __syncthreads();

    // Best admissible packed (bucket, partner root) per slot, min-reduced
    // into its region's entry of `par`.
    for (int j = tid; j < S; j += blockDim.x) {
      const int own = lab[j];
      if (blk[own]) continue;
      const int ofin = fin_t[own];
      const float om0 = label_mean(s_c0, s_size, own);
      const float om1 = label_mean(s_c1, s_size, own);
      const float om2 = label_mean(s_c2, s_size, own);
      int best = INT_MAX;
      for (int k = 0; k < K; ++k) {
        const int e = edg[(long long)k * S + j];
        if (e == INT_MAX) continue;
        const int b = e >> PBITS;
        if (b > prm.theta || b >= ofin) continue;
        const int p = min(e & PMASK, S - 1);
        const int nb = lab[p];
        if (nb == own || b >= fin_t[nb] || blk[nb]) continue;
        float d = dist32(om0, om1, om2, label_mean(s_c0, s_size, nb),
                         label_mean(s_c1, s_size, nb),
                         label_mean(s_c2, s_size, nb), l1);
        const float w_eff = __fmul_rn((float)b, 1.0f / 2048.0f);
        if (w_eff < prm.force_merge_weight && d < 0.2f) d = 0.0f;
        if (!(d < prm.merge_threshold)) continue;
        best = min(best, (b << PBITS) | nb);
      }
      if (best != INT_MAX) atomicMin(&par[own], best);
    }
    __syncthreads();

    // Parity hooking of region roots onto their best partners.
    const bool up = (i % 2) == 0;
    bool have_any = false;
    for (int j = tid; j < S; j += blockDim.x) {
      const int bt = par[j];
      const bool have = bt != INT_MAX;
      const int pt = bt & PMASK;
      have_any |= have;
      par[j] = (have && ((pt > j) == up)) ? pt : j;
    }
    const bool nhave = __syncthreads_or(have_any);

    // Pointer jumping in place: every write replaces a parent by one of its
    // ancestors, so any interleaving reaches the same roots.
    for (;;) {
      bool changed = false;
      for (int j = tid; j < S; j += blockDim.x) {
        const int p = par[j];
        const int pp = par[p];
        if (pp != p) {
          par[j] = pp;
          changed = true;
        }
      }
      if (!__syncthreads_or(changed)) break;
    }

    bool moved_any = false;
    for (int j = tid; j < S; j += blockDim.x) {
      const int nl = par[lab[j]];
      moved_any |= nl != lab[j];
      lab[j] = nl;
    }
    const bool moved = __syncthreads_or(moved_any);
    idle = !nhave ? 2 : (moved ? 0 : idle + 1);
  }

  for (int j = tid; j < S; j += blockDim.x) {
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
  if (S > MAX_SLOTS || K < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * (4 * sizeof(double) + 3 * sizeof(int));
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
  const int smem = (int)(MAX_SLOTS * (4 * sizeof(double) + 3 * sizeof(int)));
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
