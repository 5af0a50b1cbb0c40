// Tile-local Felzenszwalb pre-solve (K1) for Hopper (sm_90a).
//
// Replaces: video_segment_tpu/ops/tile_felz.py, `tile_felzenszwalb`
// (Pallas `_kernel` -> `_solve_subtile`).  On the TPU every per-label
// reduction was a one-hot MXU contraction over an (8,128) VMEM tile,
// because the TPU has no scatter.
//
// What bounds it here: not memory (one frame is read once, 16 bytes of
// outputs per pixel are written once) but the latency of the ~10 dependent
// merge phases per tile, each a chain of shared-memory atomics and block
// barriers.  The design keeps the whole tile resident: one CTA of 1024
// threads per (frame, 8x128 tile), one thread per pixel; labels, finalize
// tables, per-label sizes and float64 colour sums (56 KB) live in shared
// memory, so no phase touches device memory.  Per-label reductions are
// shared-memory atomics: atomicMin on int32 candidates / finalize levels
// and atomicAdd on float64 colour sums.  Float64 sums of <= 1024 float32
// colours in [0,1] are exact, so the atomics' order cannot move a mean and
// the kernel equals its plain PyTorch version bit for bit.  Edge buckets
// use the JAX kernel's float32 formula with round-to-nearest intrinsics
// (built with -fmad=false, never fast math): a contracted FMA would move
// int(d * 2048) across an integer boundary.
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
  double merge_threshold;
  double strong_threshold;
};

namespace {

constexpr int TH = 8;
constexpr int TW = 128;
constexpr int NPIX = TH * TW;
constexpr int NB = 2048;
constexpr int BIG = 1 << 30;     // no candidate
constexpr int OPEN = INT_MAX;    // open finalize level (>= NB)

__constant__ int kDY[8] = {0, 0, 1, -1, 1, 1, -1, -1};
__constant__ int kDX[8] = {1, -1, 0, 0, 1, -1, 1, -1};

struct Smem {
  double mean[3][NPIX];  // per-label colour sums, then means
  int size[NPIX];        // per-label pixel counts
  int lab[NPIX];         // per-pixel label (flat cell id of its root)
  int fin[NPIX];         // per-label finalize level (merge gate)
  int finx[NPIX];        // per-label exported finalize level
  int tmp_a[NPIX];       // next fin table
  int tmp_b[NPIX];       // next finx table
  int best[NPIX];        // per-label best candidate
  int parent[NPIX];      // hooking table
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

__device__ __forceinline__ double dist64(double a0, double a1, double a2,
                                         double b0, double b1, double b2,
                                         bool l1) {
  const double d0 = __dsub_rn(a0, b0);
  const double d1 = __dsub_rn(a1, b1);
  const double d2 = __dsub_rn(a2, b2);
  if (l1) {
    return __ddiv_rn(__dadd_rn(__dadd_rn(fabs(d0), fabs(d1)), fabs(d2)), 3.0);
  }
  const double ss = __dadd_rn(__dadd_rn(__dmul_rn(d0, d0), __dmul_rn(d1, d1)),
                              __dmul_rn(d2, d2));
  return __dsqrt_rn(__ddiv_rn(ss, 3.0));
}

// Per-label pixel counts and float64 colour sums of the current labelling
// (in s.size / s.mean).  Ends with a barrier.
__device__ void label_sums(Smem& s, int p, bool inb, const float* my) {
  s.size[p] = 0;
  s.mean[0][p] = 0.0;
  s.mean[1][p] = 0.0;
  s.mean[2][p] = 0.0;
  __syncthreads();
  if (inb) {
    const int a = s.lab[p];
    atomicAdd(&s.size[a], 1);
    atomicAdd(&s.mean[0][a], (double)my[0]);
    atomicAdd(&s.mean[1][a], (double)my[1]);
    atomicAdd(&s.mean[2][a], (double)my[2]);
  }
  __syncthreads();
}

// label_sums, then sums -> means (sum / max(size, 1)).  Ends with a barrier.
__device__ void label_means(Smem& s, int p, bool inb, const float* my) {
  label_sums(s, p, inb, my);
  const double den = s.size[p] > 1 ? (double)s.size[p] : 1.0;
  s.mean[0][p] = __ddiv_rn(s.mean[0][p], den);
  s.mean[1][p] = __ddiv_rn(s.mean[1][p], den);
  s.mean[2][p] = __ddiv_rn(s.mean[2][p], den);
  __syncthreads();
}

// One pixel's scan over its valid in-tile edges at bucket <= theta:
// best admissible merge candidate, min failing / strongly failing bucket.
__device__ void scan(const Smem& s, int p, unsigned valid, const int* bkt,
                     int theta, bool gated, const FelzParams& prm,
                     int* best, int* fail, int* strong) {
  const int my_lab = s.lab[p];
  const double m0 = s.mean[0][my_lab];
  const double m1 = s.mean[1][my_lab];
  const double m2 = s.mean[2][my_lab];
  const int fin_px = s.fin[my_lab];
  int b_best = BIG, b_fail = OPEN, b_strong = OPEN;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b = bkt[k];
    if (!((valid >> k) & 1u) || b > theta) continue;
    const int nb_lab = s.lab[p + kDY[k] * TW + kDX[k]];
    if (nb_lab == my_lab) continue;
    if (gated && !(b < fin_px && b < s.fin[nb_lab])) continue;
    const double dd = dist64(m0, m1, m2, s.mean[0][nb_lab],
                             s.mean[1][nb_lab], s.mean[2][nb_lab],
                             prm.metric_l1 != 0);
    if (dd < prm.merge_threshold) b_best = min(b_best, (b << 10) | nb_lab);
    if (dd >= prm.merge_threshold) b_fail = min(b_fail, b);
    if (dd >= prm.strong_threshold) b_strong = min(b_strong, b);
  }
  *best = b_best;
  *fail = b_fail;
  *strong = b_strong;
}

__global__ void __launch_bounds__(NPIX)
tile_felz_kernel(const float* __restrict__ vol, int* __restrict__ labels,
                 int* __restrict__ fin_out, float* __restrict__ size_out,
                 float* __restrict__ c0_out, float* __restrict__ c1_out,
                 float* __restrict__ c2_out, int H, int W, FelzParams prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int p = threadIdx.x;
  const int r = p / TW;
  const int c = p % TW;
  const int t = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const bool inb = (y0 + r < H) && (x0 + c < W);
  const long long pix = ((long long)t * H + (y0 + r)) * W + (x0 + c);

  float my[3] = {0.f, 0.f, 0.f};
  if (inb) {
    my[0] = vol[pix * 3 + 0];
    my[1] = vol[pix * 3 + 1];
    my[2] = vol[pix * 3 + 2];
  }
  // Colours are staged through the (not yet used) mean table.
  float* col = reinterpret_cast<float*>(&s.mean[0][0]);
  col[p] = my[0];
  col[NPIX + p] = my[1];
  col[2 * NPIX + p] = my[2];
  s.lab[p] = p;
  s.fin[p] = OPEN;
  s.finx[p] = OPEN;
  __syncthreads();

  // Static in-tile edge buckets and validity.
  int bkt[8];
  unsigned valid = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    bkt[k] = NB;
    const int r2 = r + kDY[k];
    const int c2 = c + kDX[k];
    if (inb && r2 >= 0 && r2 < TH && c2 >= 0 && c2 < TW &&
        y0 + r2 < H && x0 + c2 < W) {
      const int q = r2 * TW + c2;
      const float d = dist32(my[0], my[1], my[2], col[q], col[NPIX + q],
                             col[2 * NPIX + q], prm.metric_l1 != 0);
      const int b = (int)__fmul_rn(d, (float)NB);
      bkt[k] = min(max(b, 0), NB - 1);
      valid |= 1u << k;
    }
  }
  __syncthreads();

  const bool eager = prm.fin_eager != 0;
  for (int lv = 0; lv < prm.n_levels; ++lv) {
    const int theta = prm.schedule[lv];
    for (int rnd = 0; rnd < prm.rounds[lv]; ++rnd) {
      // ---- merge round ----
      s.best[p] = BIG;
      s.tmp_a[p] = OPEN;
      s.tmp_b[p] = OPEN;
      label_means(s, p, inb, my);
      int best, fail, strong;
      scan(s, p, valid, bkt, theta, true, prm, &best, &fail, &strong);
      const int my_lab = s.lab[p];
      if (best < BIG) atomicMin(&s.best[my_lab], best);
      if (eager) {
        // Fold the existing tables (cell p's entry) through the labels.
        atomicMin(&s.tmp_a[my_lab], min(fail, s.fin[p]));
        atomicMin(&s.tmp_b[my_lab], min(strong, s.finx[p]));
      }
      __syncthreads();
      if (eager) {
        s.fin[p] = s.tmp_a[p];
        s.finx[p] = s.tmp_b[p];
      }
      const int bt = s.best[p];
      const int partner = bt & (NPIX - 1);
      bool hook = bt < BIG && ((partner > p) == (rnd % 2 == 0));
      if (prm.pair_merge) {
        s.parent[p] = hook ? 1 : 0;
        __syncthreads();
        hook = hook && s.parent[partner] == 0;
        __syncthreads();
      }
      s.parent[p] = hook ? partner : p;
      __syncthreads();
      const int pp = s.parent[s.parent[p]];
      __syncthreads();
      s.parent[p] = pp;
      __syncthreads();
      s.lab[p] = s.parent[s.lab[p]];
      __syncthreads();
    }
    // ---- level end ----
    s.tmp_a[p] = OPEN;
    s.tmp_b[p] = OPEN;
    label_means(s, p, inb, my);
    int best, fail, strong;
    scan(s, p, valid, bkt, theta, prm.fin_gated != 0, prm, &best, &fail,
         &strong);
    const int my_lab = s.lab[p];
    if (eager) {
      atomicMin(&s.tmp_a[my_lab], min(fail, s.fin[p]));
      atomicMin(&s.tmp_b[my_lab], min(strong, s.finx[p]));
    } else {
      atomicMin(&s.tmp_a[my_lab], fail);
      atomicMin(&s.tmp_b[my_lab], strong);
    }
    __syncthreads();
    if (eager) {
      s.fin[p] = s.tmp_a[p];
      s.finx[p] = s.tmp_b[p];
    } else {
      s.fin[p] = min(s.fin[p], s.tmp_a[p]);
      s.finx[p] = min(s.finx[p], s.tmp_b[p]);
    }
    __syncthreads();
  }

  // Chain resolution to a fixed point; exported fins follow the pointers.
  while (true) {
    s.tmp_b[p] = OPEN;
    __syncthreads();
    atomicMin(&s.tmp_b[s.lab[p]], s.finx[p]);
    __syncthreads();
    s.finx[p] = s.tmp_b[p];
    const int cur = s.lab[p];
    const int nf = s.lab[cur];
    const int changed = __syncthreads_or(nf != cur);
    s.lab[p] = nf;
    __syncthreads();
    if (!changed) break;
  }

  // Final region statistics, cell-positioned at root cells.
  label_sums(s, p, inb, my);
  if (inb) {
    const int a = s.lab[p];
    labels[pix] = (int)((long long)t * H * W +
                        (long long)(y0 + a / TW) * W + (x0 + a % TW));
    fin_out[pix] = min(s.finx[a], NB);
    size_out[pix] = (float)s.size[p];
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
  tile_felz_kernel<<<grid, NPIX, smem, (cudaStream_t)stream>>>(
      (const float*)vol, (int*)labels, (int*)fin, (float*)size, (float*)c0,
      (float*)c1, (float*)c2, H, W, *prm);
  return (int)cudaGetLastError();
}
