// Per-tile edge-key minima (K2) for Hopper (sm_90a).
//
// Replaces: video_segment_tpu/ops/tile_extract.py, `tile_reduce_min`
// (Pallas `_kernel`, `_label_min_i32`).  After the tile pre-solve every
// non-head region is local to one (8,128) tile, so the edge-table
// extraction's per-(region, direction) minima reduce inside the tile and
// the table then gathers each region's minima from its root cell.
//
// What bounds it here: memory traffic.  A 21-frame 272x480 chunk with 13
// directions reads 143 MB of keys and writes 143 MB of minima; the
// arithmetic is one integer compare per key.  The design reads every key
// and writes every output exactly once, coalesced (one CTA of 1024 threads
// per (frame, 8x128 tile); a thread per pixel, consecutive threads on
// consecutive columns), and keeps the per-label table in shared memory:
// per direction, a 1024-entry int32 table is reset to I32MAX, keys meet at
// their region's root cell by shared-memory atomicMin, and every thread
// writes its own cell's minimum.  Exact integer work: the result equals
// the plain version bit for bit.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int TH = 8;
constexpr int TW = 128;
constexpr int NPIX = TH * TW;

__global__ void __launch_bounds__(NPIX)
tile_reduce_min_kernel(const int* __restrict__ labr,
                       const int* __restrict__ labc,
                       const int* __restrict__ keys, int* __restrict__ out,
                       int D, int T, int H, int W) {
  __shared__ int table[NPIX];
  const int p = threadIdx.x;
  const int y = blockIdx.y * TH + p / TW;
  const int x = blockIdx.x * TW + p % TW;
  const bool inb = (y < H) && (x < W);
  const long long plane = (long long)T * H * W;
  const long long pix = ((long long)blockIdx.z * H + y) * W + x;
  int cell = -1;
  if (inb) {
    const int lr = labr[pix];
    const int lc = labc[pix];
    // Labels outside the tile match no cell (the one-hot semantics).
    if (lr >= 0 && lr < TH && lc >= 0 && lc < TW) cell = lr * TW + lc;
  }
  for (int d = 0; d < D; ++d) {
    table[p] = INT_MAX;
    __syncthreads();
    if (cell >= 0) {
      const int k = keys[d * plane + pix];
      if (k != INT_MAX) atomicMin(&table[cell], k);
    }
    __syncthreads();
    if (inb) out[d * plane + pix] = table[p];
    __syncthreads();
  }
}

}  // namespace

extern "C" int tile_reduce_min_launch(const void* labr, const void* labc,
                                      const void* keys, void* out, int D,
                                      int T, int H, int W, void* stream) {
  if (D <= 0 || T <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, T);
  tile_reduce_min_kernel<<<grid, NPIX, 0, (cudaStream_t)stream>>>(
      (const int*)labr, (const int*)labc, (const int*)keys, (int*)out, D, T,
      H, W);
  return (int)cudaGetLastError();
}

// out: registers a thread, local (spill) bytes a thread, static and
// dynamic shared memory bytes a CTA, threads a CTA, resident CTAs an SM.
extern "C" int tile_extract_resources(int* out) {
  const int smem = 0;
  cudaError_t e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, tile_reduce_min_kernel);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, tile_reduce_min_kernel,
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
