// Tile-local Felzenszwalb pre-solve (K1) for Hopper (sm_90a).
//
// Replaces: video_segment_tpu/ops/tile_felz.py, `tile_felzenszwalb`
// (Pallas `_kernel` -> `_solve_subtile`).  On the TPU every per-label
// reduction was a one-hot MXU contraction over an (8,128) VMEM tile,
// because the TPU has no scatter.
//
// What bounds it here: not memory (one frame is read once, 24 bytes of
// outputs per pixel are written once) but the latency of the dependent
// merge phases of each tile (block barriers between shared-memory table
// updates) and the float64 work of the mean-colour gate.  The design:
//
// - One CTA of 512 threads per (frame, 8x128 tile); each thread owns two
//   pixels and two label slots (p and p + 512).  108 KB of shared memory
//   and at most 64 registers a thread (__launch_bounds__(512, 2)) let two
//   CTAs share an SM, so a 272x480 frame (136 tiles) runs in one wave on
//   132 SMs.
// - The gate tests sqrt(ss / 3) < threshold (L2; sum / 3 for L1) in
//   float64.  Division and square root are monotone under round to
//   nearest, so the test equals `ss < key` for the least float64 `key`
//   whose distance reaches the threshold; the wrapper finds that key by
//   bisection over float64 bit patterns with NumPy's correctly rounded
//   arithmetic.  A tested edge costs 3 subtractions, 3 products and 2
//   additions in float64 and no divide or square root.
// - Per-label sums are kept, not recounted: a round's pointer jump moves
//   every pixel of label x to g(x) = parent[parent[x]], so each label in
//   use that moves adds its sums to g(x) (one atomic per label, not per
//   pixel), and only labels whose sums grew get new means.  A round that
//   hooks nothing changes no label and costs no barrier beyond its scan
//   and hook.  Float64 sums of <= 1024 float32 colours in [0,1] are exact,
//   so the moved sums equal a recount, no atomic order can move a mean,
//   and the kernel equals its plain PyTorch version bit for bit.
// - The final statistics are one recount from the pixels, warp-aggregated
//   (__match_any_sync groups a warp's pixels by label, a shuffle tree sums
//   each group, one lane issues the group's atomics).
// - Table resets ride in the phase that consumes the table, and the
//   pointer jump reads parent[parent[lab]] in one phase: a round has five
//   barriers when labels change and two when they do not (the JAX kernel's
//   literal port had eight).
//
// Edge buckets use the JAX kernel's float32 formula with round-to-nearest
// intrinsics (built with -fmad=false, never fast math): a contracted FMA
// would move int(d * 2048) across an integer boundary.
//
// Round structure (NumPy mirror `tile_felz_reference`): per schedule level,
// `rounds` Boruvka merge rounds (per-label min (bucket<<10 | partner),
// parity hooking, one pointer jump; eager finalization folds failed tests
// into the fin tables with a one-round lag) and one level-end failure scan
// (gated by the fin tables when fin_gated), then a fixed-point chain
// resolution that min-propagates the exported finalize levels.

#include <cuda_runtime.h>

#include <climits>

constexpr int MAX_LEVELS = 16;

// Must match `_Params` in ops/tile_felz.py.
struct FelzParams {
  int schedule[MAX_LEVELS];
  int rounds[MAX_LEVELS];
  int n_levels;
  int metric_l1;
  int fin_eager;
  int fin_gated;
  int pair_merge;
  // Least float64 distance key (ss for L2, |d0|+|d1|+|d2| for L1) whose
  // distance is >= merge_threshold / >= merge_threshold * fin_margin.
  double merge_key;
  double strong_key;
};

namespace {

constexpr int TH = 8;
constexpr int TW = 128;
constexpr int NPIX = TH * TW;
constexpr int NT = 512;            // threads per CTA
constexpr int PPT = NPIX / NT;     // pixels (and label slots) per thread
constexpr int NB = 2048;
constexpr int BIG = 1 << 30;       // no candidate
constexpr int OPEN = INT_MAX;      // open finalize level (>= NB)
constexpr int GREW = -1;           // parent[] mark: the label's sums grew
constexpr unsigned short NO_EDGE = 0xFFFF;
constexpr unsigned FULL = 0xFFFFFFFFu;

// In-tile N8 direction k as (dy, dx): (0,1) (0,-1) (1,0) (-1,0) (1,1)
// (1,-1) (-1,1) (-1,-1); constant-folded in unrolled loops.
__device__ __forceinline__ int dir_dy(int k) {
  return k == 2 || k == 4 || k == 5 ? 1 : (k == 3 || k >= 6 ? -1 : 0);
}
__device__ __forceinline__ int dir_dx(int k) {
  return k == 0 || k == 4 || k == 6 ? 1 : (k == 1 || k == 5 || k == 7 ? -1
                                                                      : 0);
}

struct Smem {
  double sum[3][NPIX];           // per-label colour sums (exact)
  double mean[3][NPIX];          // per-label means; final sums at the end
  int size[NPIX];                // per-label pixel counts
  int lab[NPIX];                 // per-pixel label (flat cell id)
  int fin[NPIX];                 // per-label finalize level (merge gate)
  int finx[NPIX];                // per-label exported finalize level
  int tmp_a[NPIX];               // next fin table; final sizes at the end
  int tmp_b[NPIX];               // next finx table
  int best[NPIX];                // per-label best candidate
  int parent[NPIX];              // hooking table, then GREW marks
  float col[3][NPIX];            // pixel colours
  unsigned short bkt[8][NPIX];   // in-tile edge buckets (NO_EDGE: none)
};

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

// The float64 gate distance before its monotone divide (and square root).
__device__ __forceinline__ double dist_key(double a0, double a1, double a2,
                                           double b0, double b1, double b2,
                                           bool l1) {
  const double d0 = __dsub_rn(a0, b0);
  const double d1 = __dsub_rn(a1, b1);
  const double d2 = __dsub_rn(a2, b2);
  if (l1) return __dadd_rn(__dadd_rn(fabs(d0), fabs(d1)), fabs(d2));
  return __dadd_rn(__dadd_rn(__dmul_rn(d0, d0), __dmul_rn(d1, d1)),
                   __dmul_rn(d2, d2));
}

// Sum a, b, c over each lane's peer group (lanes with an equal key); the
// group's lowest lane ends with the totals.  A shuffle tree: each step
// every remaining peer adds the value of its next-higher remaining peer,
// then the peers of odd rank drop out.  All 32 lanes must call it.
__device__ __forceinline__ void reduce_peers(unsigned peers, unsigned lane,
                                             double& a, double& b,
                                             double& c) {
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xFFFFFFFEu << lane);
  while (__any_sync(FULL, rest != 0u)) {
    const int next = __ffs(rest);
    const int src = next ? next - 1 : (int)lane;
    const double ta = __shfl_sync(FULL, a, src);
    const double tb = __shfl_sync(FULL, b, src);
    const double tc = __shfl_sync(FULL, c, src);
    if (next) {
      a = __dadd_rn(a, ta);
      b = __dadd_rn(b, tb);
      c = __dadd_rn(c, tc);
    }
    rest &= ~__ballot_sync(FULL, rank & 1u);
    rank >>= 1;
  }
}

// Per-label pixel counts and float64 colour sums of the current labelling
// into the zeroed tables `size` and `sum`, one shared-memory atomic per
// (warp, label).  No barrier.
__device__ __forceinline__ void accumulate(Smem& s, int t, unsigned inb,
                                           int* size, double (*sum)[NPIX]) {
  const unsigned lane = t & 31;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = t + i * NT;
    const bool in = (inb >> i) & 1u;
    const int key = in ? s.lab[p] : -1;
    double a = in ? (double)s.col[0][p] : 0.0;
    double b = in ? (double)s.col[1][p] : 0.0;
    double c = in ? (double)s.col[2][p] : 0.0;
    const unsigned peers = __match_any_sync(FULL, key);
    reduce_peers(peers, lane, a, b, c);
    if (key >= 0 && (int)lane == __ffs(peers) - 1) {
      atomicAdd(&size[key], __popc(peers));
      atomicAdd(&sum[0][key], a);
      atomicAdd(&sum[1][key], b);
      atomicAdd(&sum[2][key], c);
    }
  }
}

// One pixel's scan over its in-tile edges at bucket <= theta: best
// admissible merge candidate, min failing / strongly failing bucket.
// `valid`: the pixel's in-tile, in-frame edges as bits.
__device__ __forceinline__ void scan(const Smem& s, int p, unsigned valid,
                                     int theta, bool gated,
                                     const FelzParams& prm, int* best,
                                     int* fail, int* strong) {
  const int my_lab = s.lab[p];
  int nb[8], bk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // Invalid edges read the pixel itself, whose label equals its own.
    const int q = ((valid >> k) & 1u) ? p + dir_dy(k) * TW + dir_dx(k) : p;
    nb[k] = s.lab[q];
    bk[k] = s.bkt[k][p];
  }
  const double m0 = s.mean[0][my_lab];
  const double m1 = s.mean[1][my_lab];
  const double m2 = s.mean[2][my_lab];
  const int fin_px = s.fin[my_lab];
  const bool l1 = prm.metric_l1 != 0;
  int b_best = BIG, b_fail = OPEN, b_strong = OPEN;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b = bk[k];
    const int nb_lab = nb[k];
    if (nb_lab == my_lab || b > theta) continue;
    if (gated && !(b < fin_px && b < s.fin[nb_lab])) continue;
    const double key = dist_key(m0, m1, m2, s.mean[0][nb_lab],
                                s.mean[1][nb_lab], s.mean[2][nb_lab], l1);
    if (key < prm.merge_key) {
      b_best = min(b_best, (b << 10) | nb_lab);
    } else {
      b_fail = min(b_fail, b);
    }
    if (key >= prm.strong_key) b_strong = min(b_strong, b);
  }
  *best = b_best;
  *fail = b_fail;
  *strong = b_strong;
}

// Scan every owned pixel and fold the results into the per-label tables:
// best candidates (rounds), and the fin tables through the labels (eager:
// with cell p's own entries; else the failures alone).  No barrier.
__device__ __forceinline__ void scan_and_fold(Smem& s, int t,
                                              const unsigned* valid,
                                              int theta, bool gated,
                                              bool round, bool eager,
                                              const FelzParams& prm) {
  // Not unrolled: two pixels' scans at once spill registers.
#pragma unroll 1
  for (int i = 0; i < PPT; ++i) {
    const int p = t + i * NT;
    int best, fail, strong;
    scan(s, p, valid[i], theta, gated, prm, &best, &fail, &strong);
    const int my_lab = s.lab[p];
    if (round && best < BIG) atomicMin(&s.best[my_lab], best);
    if (eager) {
      atomicMin(&s.tmp_a[my_lab], min(fail, s.fin[p]));
      atomicMin(&s.tmp_b[my_lab], min(strong, s.finx[p]));
    } else if (!round) {
      atomicMin(&s.tmp_a[my_lab], fail);
      atomicMin(&s.tmp_b[my_lab], strong);
    }
  }
}

__global__ void __launch_bounds__(NT, 2)
tile_felz_kernel(const float* __restrict__ vol, int* __restrict__ labels,
                 int* __restrict__ fin_out, float* __restrict__ size_out,
                 float* __restrict__ c0_out, float* __restrict__ c1_out,
                 float* __restrict__ c2_out, int H, int W, FelzParams prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const int frame = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;

  // ---- init: colours, tables; every pixel its own label ----
  unsigned inb = 0;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = t + i * NT;
    const int r = p / TW, c = p % TW;
    const bool in = (y0 + r < H) && (x0 + c < W);
    inb |= (unsigned)in << i;
    const long long pix = ((long long)frame * H + (y0 + r)) * W + (x0 + c);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v = in ? vol[pix * 3 + ch] : 0.f;
      s.col[ch][p] = v;
      s.sum[ch][p] = (double)v;
      s.mean[ch][p] = (double)v;
    }
    s.size[p] = in ? 1 : 0;
    s.lab[p] = p;
    s.fin[p] = OPEN;
    s.finx[p] = OPEN;
    s.tmp_a[p] = OPEN;
    s.tmp_b[p] = OPEN;
    s.best[p] = BIG;
  }
  __syncthreads();

  // Static in-tile edge buckets and validity.
  unsigned valid[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = t + i * NT;
    const int r = p / TW, c = p % TW;
    const bool in = (inb >> i) & 1u;
    valid[i] = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r2 = r + dir_dy(k);
      const int c2 = c + dir_dx(k);
      unsigned short out = NO_EDGE;
      if (in && r2 >= 0 && r2 < TH && c2 >= 0 && c2 < TW &&
          y0 + r2 < H && x0 + c2 < W) {
        const int q = r2 * TW + c2;
        const float d = dist32(s.col[0][p], s.col[1][p], s.col[2][p],
                               s.col[0][q], s.col[1][q], s.col[2][q],
                               prm.metric_l1 != 0);
        const int b = (int)__fmul_rn(d, (float)NB);
        out = (unsigned short)min(max(b, 0), NB - 1);
        valid[i] |= 1u << k;
      }
      s.bkt[k][p] = out;
    }
  }
  __syncthreads();

  const bool eager = prm.fin_eager != 0;
  for (int lv = 0; lv < prm.n_levels; ++lv) {
    const int theta = prm.schedule[lv];
    for (int rnd = 0; rnd < prm.rounds[lv]; ++rnd) {
      // ---- merge round ----
      // Merge candidates are always gated by fin (the mirror's adm).
      scan_and_fold(s, t, valid, theta, true, true, eager, prm);
      __syncthreads();
      int partner[PPT];
      bool hook[PPT];
      bool any_hook = false;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = t + i * NT;
        if (eager) {
          s.fin[p] = s.tmp_a[p];
          s.finx[p] = s.tmp_b[p];
          s.tmp_a[p] = OPEN;
          s.tmp_b[p] = OPEN;
        }
        const int bt = s.best[p];
        s.best[p] = BIG;
        partner[i] = bt & (NPIX - 1);
        hook[i] = bt < BIG && ((partner[i] > p) == (rnd % 2 == 0));
      }
      if (prm.pair_merge) {
#pragma unroll
        for (int i = 0; i < PPT; ++i) s.parent[t + i * NT] = hook[i] ? 1 : 0;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PPT; ++i)
          hook[i] = hook[i] && s.parent[partner[i]] == 0;
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = t + i * NT;
        s.parent[p] = hook[i] ? partner[i] : p;
        any_hook = any_hook || hook[i];
      }
      // No hook anywhere: parent is the identity; labels and means stay.
      if (!__syncthreads_or(any_hook)) continue;
      // Pointer jump: pixels of label x move to g(x) = parent[parent[x]].
      // A label in use that moves hands its sums to g(x); sums of float32
      // colours are exact, so they equal a recount from the pixels.
      int to[PPT], n[PPT];
      double v[PPT][3];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = t + i * NT;
        s.lab[p] = s.parent[s.parent[s.lab[p]]];
        to[i] = -1;
        n[i] = s.size[p];
        if (n[i] > 0) {
          const int g = s.parent[s.parent[p]];
          if (g != p) {
            to[i] = g;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              v[i][ch] = s.sum[ch][p];
              s.sum[ch][p] = 0.0;
            }
            s.size[p] = 0;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        if (to[i] < 0) continue;
        atomicAdd(&s.size[to[i]], n[i]);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) atomicAdd(&s.sum[ch][to[i]], v[i][ch]);
        s.parent[to[i]] = GREW;
      }
      __syncthreads();
      // Means (sum / max(size, 1)) of the labels whose sums grew.
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int p = t + i * NT;
        if (s.parent[p] != GREW) continue;
        const int cnt = s.size[p];
        const double den = cnt > 1 ? (double)cnt : 1.0;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          s.mean[ch][p] = __ddiv_rn(s.sum[ch][p], den);
      }
      __syncthreads();
    }
    // ---- level end ----
    scan_and_fold(s, t, valid, theta, prm.fin_gated != 0, false, eager,
                  prm);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = t + i * NT;
      if (eager) {
        s.fin[p] = s.tmp_a[p];
        s.finx[p] = s.tmp_b[p];
      } else {
        s.fin[p] = min(s.fin[p], s.tmp_a[p]);
        s.finx[p] = min(s.finx[p], s.tmp_b[p]);
      }
      s.tmp_a[p] = OPEN;
      s.tmp_b[p] = OPEN;
    }
    __syncthreads();
  }

  // The final statistics go to the mean and tmp_a tables, which nothing
  // reads from here on; their zeroing is published by the barriers below.
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = t + i * NT;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) s.mean[ch][p] = 0.0;
  }

  // Chain resolution to a fixed point; exported fins follow the pointers.
  while (true) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = t + i * NT;
      atomicMin(&s.tmp_b[s.lab[p]], s.finx[p]);
    }
    __syncthreads();
    int nf[PPT];
    bool moved = false;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = t + i * NT;
      s.finx[p] = s.tmp_b[p];
      const int cur = s.lab[p];
      nf[i] = s.lab[cur];
      moved = moved || nf[i] != cur;
    }
    const int changed = __syncthreads_or(moved);
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = t + i * NT;
      s.lab[p] = nf[i];
      s.tmp_b[p] = OPEN;
      s.tmp_a[p] = 0;
    }
    __syncthreads();
    if (!changed) break;
  }

  // Final region statistics, cell-positioned at root cells.
  accumulate(s, t, inb, s.tmp_a, s.mean);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    if (!((inb >> i) & 1u)) continue;
    const int p = t + i * NT;
    const int r = p / TW, c = p % TW;
    const long long pix = ((long long)frame * H + (y0 + r)) * W + (x0 + c);
    const int a = s.lab[p];
    labels[pix] = (int)((long long)frame * H * W +
                        (long long)(y0 + a / TW) * W + (x0 + a % TW));
    fin_out[pix] = min(s.finx[a], NB);
    size_out[pix] = (float)s.tmp_a[p];
    c0_out[pix] = (float)s.mean[0][p];
    c1_out[pix] = (float)s.mean[1][p];
    c2_out[pix] = (float)s.mean[2][p];
  }
}

}  // namespace

extern "C" int tile_felz_launch(const void* vol, void* labels, void* fin,
                                void* size, void* c0, void* c1, void* c2,
                                int T, int H, int W, const FelzParams* prm,
                                void* stream) {
  if (T <= 0 || H <= 0 || W <= 0) return 0;
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      tile_felz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, T);
  tile_felz_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)vol, (int*)labels, (int*)fin, (float*)size, (float*)c0,
      (float*)c1, (float*)c2, H, W, *prm);
  return (int)cudaGetLastError();
}

// out: registers a thread, local (spill) bytes a thread, static and
// dynamic shared memory bytes a CTA, threads a CTA, resident CTAs an SM.
extern "C" int tile_felz_resources(int* out) {
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      tile_felz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, tile_felz_kernel);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, tile_felz_kernel,
                                                    NT, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = smem;
  out[4] = NT;
  out[5] = ctas;
  return 0;
}
