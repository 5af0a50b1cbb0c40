// Tile flood pre-segmentation (K4) for Hopper (sm_90a).
//
// Replaces: video_segment_tpu/ops/tile_preseg.py, `tile_presegment`
// (Pallas `_kernel`).  Inside every (8,128) tile, labels min-flood for
// `iters` Jacobi iterations over the in-tile N4 edges whose colour distance
// is <= threshold; roots become global voxel ids.  The caller collapses the
// remaining label chains with a pointer jump.
//
// What bounds it here: not memory (a tile's colours are read once, 12 KB,
// and its labels written once, 4 KB) but the dependent chain of iterations
// and the integer instructions in each.  The design keeps a tile in one
// warp's registers, so an iteration needs no block barrier: lane l owns the
// 8x4 pixels of columns 4l..4l+3.  Labels are 10-bit tile-local ids, two to
// a 32-bit register: per row, register A holds columns 0 and 2 of the lane
// (low, high half) and B columns 1 and 3, so B is A's right neighbours and
// A is B's left ones, and one three-way `__vimin3_u16x2` (a Hopper DPX
// instruction) takes two pixels' minima over two neighbours.  An absent
// edge is a 0x8000 half in a mask that is added to the neighbour's labels
// (ids are below 1024, so the sum loses every min and never carries into
// the other half): the adds run as IMAD on the FMA pipe, beside the min and
// logic instructions of the integer pipe, which is half as wide (OR-ing a
// 0xFFFF mask there was 15% slower).  Vertical neighbours are the lane's
// own registers; the horizontal ones across lanes come by
// `__shfl_up_sync` / `__shfl_down_sync`.  The update stays Jacobi: a row's
// new labels come from the old labels of the rows above (kept in a copy)
// and below and of the neighbouring lanes (shuffled before the row is
// written); an in-place Gauss-Seidel update would flood further and give
// other labels after the pointer jump.  A warp stops at the first iteration
// that changes no label: every later iteration would repeat it, so the
// labels equal those of all `iters` iterations.  Pixels outside the frame
// of a ragged edge tile take no edge (the JAX version pads them with 1e6
// colours).  The distance uses the JAX kernel's float32 formula with
// round-to-nearest intrinsics (built with -fmad=false), and for l2 the
// square root is replaced by a compare with a precomputed key: the same
// edges as the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;
constexpr int TW = 128;
constexpr int COLS = 4;             // columns a lane owns
constexpr int WARPS = 2;            // tiles (warps) a CTA
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned BLOCK_LO = 0x00008000u;
constexpr unsigned BLOCK_HI = 0x80000000u;

// The JAX kernel's distance without its final square root for l2: the
// l1 distance, or the mean squared difference whose square root is the l2
// distance.  The square root is monotone, so the caller compares the mean
// square with the largest float32 whose root is <= threshold (`flood_key`
// in ops/tile_preseg.py).
__device__ __forceinline__ float dist_key(float a0, float a1, float a2,
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
  return __fmul_rn(ss, 1.0f / 3.0f);
}

// 0x8000 in the low / high half where the edge is absent.
__device__ __forceinline__ unsigned pair_mask(bool lo, bool hi) {
  return (lo ? 0u : BLOCK_LO) | (hi ? 0u : BLOCK_HI);
}

// (a.hi, b.lo) as (low, high) halves.
__device__ __forceinline__ unsigned shift_pair(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5432);
}

// Per-halfword min(a, b, c).
__device__ __forceinline__ unsigned vmin3(unsigned a, unsigned b,
                                          unsigned c) {
  return __vimin3_u16x2(a, b, c);
}

// At least 11 two-warp CTAs an SM (at most 93 registers a thread), so a
// (21,272,480) chunk's 2856 tiles fit one wave on 132 SMs.
__global__ void __launch_bounds__(THREADS, 11)
tile_preseg_kernel(const float* __restrict__ vol, int* __restrict__ out,
                   int* __restrict__ tile_iters, int H, int W, int nty,
                   int ntx, int ntiles, float key, int l1, int iters) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (tile >= ntiles) return;       // whole warps only
  const int t = tile / (nty * ntx);
  const int ty = (tile / ntx) % nty;
  const int tx = tile % ntx;
  const int y0 = ty * TH;
  const int xl = tx * TW + lane * COLS;   // first column of this lane
  const bool l1m = l1 != 0;

  // Edge flags, one bit a pixel, built one row at a time from the colours
  // of that row and the one above: rt the edge to the right (column 3's to
  // the lane to the right's column 0), lt the edge into column 0 from the
  // lane to the left, dn the edge from row r down (bit 4r + c).
  unsigned rt_bits = 0, dn_bits = 0, lt_bits = 0;
  float prev[COLS][3];
  bool prev_in[COLS];
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int y = y0 + r;
    float col[COLS][3];
    bool in[COLS];
    const float* px = vol + (((long long)t * H + y) * W + xl) * 3;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      in[c] = y < H && xl + c < W;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) col[c][ch] = in[c] ? px[3 * c + ch] : 0.f;
    }
    // Column 0 of the lane to the right, for this lane's last right edge.
    float nxt[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      nxt[ch] = __shfl_down_sync(FULL, col[0][ch], 1);
    }
    const bool nxt_in =
        __shfl_down_sync(FULL, (int)in[0], 1) != 0 && lane < 31;
#pragma unroll
    for (int c = 0; c < COLS - 1; ++c) {
      const bool e = in[c] && in[c + 1] &&
                     dist_key(col[c][0], col[c][1], col[c][2], col[c + 1][0],
                              col[c + 1][1], col[c + 1][2], l1m) <= key;
      rt_bits |= (unsigned)e << (4 * r + c);
    }
    const bool e3 = in[COLS - 1] && nxt_in &&
                    dist_key(col[COLS - 1][0], col[COLS - 1][1],
                             col[COLS - 1][2], nxt[0], nxt[1], nxt[2],
                             l1m) <= key;
    rt_bits |= (unsigned)e3 << (4 * r + COLS - 1);
    // Right edge of the lane to the left's last column.
    const bool lt0 = __shfl_up_sync(FULL, (int)e3, 1) != 0 && lane > 0;
    lt_bits |= (unsigned)lt0 << r;
    if (r > 0) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const bool e = prev_in[c] && in[c] &&
                       dist_key(prev[c][0], prev[c][1], prev[c][2],
                                col[c][0], col[c][1], col[c][2], l1m) <= key;
        dn_bits |= (unsigned)e << (4 * (r - 1) + c);
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      prev_in[c] = in[c];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) prev[c][ch] = col[c][ch];
    }
  }

  // Edge masks in the registers' layout (added to the neighbours' labels):
  // m02 the edges between A and B (columns 0-1 and 2-3), mla A's left edges
  // (the lane to the left's column 3 to column 0, column 1 to 2), mrb B's
  // right edges (1 to 2, 3 to the lane to the right's column 0), mda / mdb
  // the edges from row r down (row r+1's up edges too).
  unsigned m02[TH], mla[TH], mrb[TH], mda[TH - 1], mdb[TH - 1];
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const unsigned rt = rt_bits >> (4 * r);
    m02[r] = pair_mask(rt & 1u, rt & 4u);
    mla[r] = pair_mask((lt_bits >> r) & 1u, rt & 2u);
    mrb[r] = pair_mask(rt & 2u, rt & 8u);
    if (r < TH - 1) {
      const unsigned dn = dn_bits >> (4 * r);
      mda[r] = pair_mask(dn & 1u, dn & 4u);
      mdb[r] = pair_mask(dn & 2u, dn & 8u);
    }
  }

  // Packed labels of row r: la[r] columns 0 and 2, lb[r] columns 1 and 3.
  unsigned la[TH], lb[TH];
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const unsigned id = r * TW + lane * COLS;
    la[r] = id | ((id + 2) << 16);
    lb[r] = (id + 1) | ((id + 3) << 16);
  }

  int it = 0;
  for (; it < iters; ++it) {
    unsigned changed = 0;
    unsigned up_a = 0, up_b = 0;      // old labels of the row above
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      const unsigned a = la[r];
      const unsigned b = lb[r];
      // The lane to the left's columns (1, 3) and to the right's (0, 2).
      const unsigned left = __shfl_up_sync(FULL, b, 1);
      const unsigned right = __shfl_down_sync(FULL, a, 1);
      unsigned na = vmin3(a, b + m02[r], shift_pair(left, b) + mla[r]);
      unsigned nb = vmin3(b, a + m02[r], shift_pair(a, right) + mrb[r]);
      if (r > 0 && r < TH - 1) {
        na = vmin3(na, up_a + mda[r - 1], la[r + 1] + mda[r]);
        nb = vmin3(nb, up_b + mdb[r - 1], lb[r + 1] + mdb[r]);
      } else if (r > 0) {
        na = __vminu2(na, up_a + mda[r - 1]);
        nb = __vminu2(nb, up_b + mdb[r - 1]);
      } else {
        na = __vminu2(na, la[r + 1] + mda[r]);
        nb = __vminu2(nb, lb[r + 1] + mdb[r]);
      }
      changed |= (na ^ a) | (nb ^ b);
      up_a = a;
      up_b = b;
      la[r] = na;
      lb[r] = nb;
    }
    if (!__any_sync(FULL, changed != 0)) break;
  }
  if (tile_iters != nullptr && lane == 0) tile_iters[tile] = it;

  // Global voxel ids of the roots: the tile's first voxel plus the root's
  // row and column (ids fit int32: the wrapper checks T*H*W < 2^31).
  const int tile0 = (t * H + y0) * W + tx * TW;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    int* o = out + ((long long)t * H + y0 + r) * W + xl;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const unsigned v = (c & 1) ? lb[r] : la[r];
      const int root = (int)((c & 2) ? v >> 16 : v & 0xffffu);
      if (y0 + r < H && xl + c < W) {
        o[c] = tile0 + (root / TW) * W + root % TW;
      }
    }
  }
}

}  // namespace

// tile_iters: null, or an int per tile that receives the number of
// iterations that changed a label there.
// key: the threshold for l1, `flood_key(threshold)` for l2.
extern "C" int tile_preseg_launch(const void* vol, void* out, void* tile_iters,
                                  int T, int H, int W, float key, int l1,
                                  int iters, void* stream) {
  if (T <= 0 || H <= 0 || W <= 0) return 0;
  const int nty = (H + TH - 1) / TH;
  const int ntx = (W + TW - 1) / TW;
  const int ntiles = T * nty * ntx;
  const int grid = (ntiles + WARPS - 1) / WARPS;
  tile_preseg_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)vol, (int*)out, (int*)tile_iters, H, W, nty, ntx, ntiles,
      key, l1, iters);
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
