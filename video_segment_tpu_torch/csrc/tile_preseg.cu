// Tile flood pre-segmentation (K4) for Hopper (sm_90a).
//
// Replaces: video_segment_tpu/ops/tile_preseg.py, `tile_presegment`
// (Pallas `_kernel`).  Inside every (8,128) tile, labels min-flood for
// exactly `iters` Jacobi iterations over the in-tile N4 edges whose colour
// distance is <= threshold; roots become global voxel ids.  The caller
// collapses the remaining label chains with a pointer jump.
//
// What bounds it here: the latency of `iters` dependent block barriers
// (48 by default), not memory: a tile's colours are read once (12 KB) and
// its labels written once (4 KB).  The design keeps the tile resident: one
// CTA of 1024 threads per (frame, 8x128 tile), one thread per pixel.  Each
// thread computes its four edge flags once (its down / right edges, and via
// shared memory its up / left ones) and keeps them in registers; labels are
// double-buffered in shared memory, so every iteration reads only the
// start-of-iteration labelling, as the Pallas body does (an in-place,
// Gauss-Seidel update would flood further and give other labels after the
// pointer jump).  Pixels outside the frame of a ragged edge tile take no
// edge (the JAX version pads them with 1e6 colours).  The distance uses the
// JAX kernel's float32 formula with round-to-nearest intrinsics (built with
// -fmad=false): the same bits as the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;
constexpr int TW = 128;
constexpr int NPIX = TH * TW;

__device__ __forceinline__ float dist32(const float* a, const float* b,
                                        bool l1) {
  const float d0 = __fsub_rn(a[0], b[0]);
  const float d1 = __fsub_rn(a[1], b[1]);
  const float d2 = __fsub_rn(a[2], b[2]);
  if (l1) {
    return __fmul_rn(__fadd_rn(__fadd_rn(fabsf(d0), fabsf(d1)), fabsf(d2)),
                     1.0f / 3.0f);
  }
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                             __fmul_rn(d2, d2));
  return __fsqrt_rn(__fmul_rn(ss, 1.0f / 3.0f));
}

__global__ void __launch_bounds__(NPIX)
tile_preseg_kernel(const float* __restrict__ vol, int* __restrict__ out,
                   int H, int W, float threshold, int l1, int iters) {
  __shared__ float col[NPIX][3];
  __shared__ unsigned char down[NPIX];
  __shared__ unsigned char right[NPIX];
  __shared__ int lab[2][NPIX];

  const int p = threadIdx.x;
  const int r = p / TW;
  const int c = p % TW;
  const int y = blockIdx.y * TH + r;
  const int x = blockIdx.x * TW + c;
  const bool inb = (y < H) && (x < W);
  const long long pix = ((long long)blockIdx.z * H + y) * W + x;
  if (inb) {
    col[p][0] = vol[pix * 3 + 0];
    col[p][1] = vol[pix * 3 + 1];
    col[p][2] = vol[pix * 3 + 2];
  }
  __syncthreads();
  // Edges to the pixel below / to the right, held at their upper / left end.
  const bool dn = inb && r < TH - 1 && y + 1 < H &&
                  dist32(col[p], col[p + TW], l1) <= threshold;
  const bool rt = inb && c < TW - 1 && x + 1 < W &&
                  dist32(col[p], col[p + 1], l1) <= threshold;
  down[p] = dn;
  right[p] = rt;
  lab[0][p] = p;
  __syncthreads();
  const bool up = r > 0 && down[p - TW];
  const bool lt = c > 0 && right[p - 1];

  int cur = 0;
  for (int it = 0; it < iters; ++it) {
    const int* src = lab[cur];
    int v = src[p];
    if (up) v = min(v, src[p - TW]);
    if (dn) v = min(v, src[p + TW]);
    if (lt) v = min(v, src[p - 1]);
    if (rt) v = min(v, src[p + 1]);
    lab[cur ^ 1][p] = v;
    cur ^= 1;
    __syncthreads();
  }

  if (inb) {
    const int root = lab[cur][p];
    const int ry = blockIdx.y * TH + root / TW;
    const int rx = blockIdx.x * TW + root % TW;
    out[pix] = (int)(((long long)blockIdx.z * H + ry) * W + rx);
  }
}

}  // namespace

extern "C" int tile_preseg_launch(const void* vol, void* out, int T, int H,
                                  int W, float threshold, int l1, int iters,
                                  void* stream) {
  if (T <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, T);
  tile_preseg_kernel<<<grid, NPIX, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (int*)out, H, W, threshold, l1, iters);
  return (int)cudaGetLastError();
}

// out: registers a thread, local (spill) bytes a thread, static and
// dynamic shared memory bytes a CTA, threads a CTA, resident CTAs an SM.
extern "C" int tile_preseg_resources(int* out) {
  const int smem = 0;
  cudaError_t e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, tile_preseg_kernel);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, tile_preseg_kernel,
                                                    NPIX, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = smem;
  out[4] = NPIX;
  out[5] = ctas;
  return 0;
}
