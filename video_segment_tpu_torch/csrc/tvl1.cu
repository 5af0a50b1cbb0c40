// TV-L1 optical flow, one pyramid scale (K5) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs TV-L1 as XLA ops
// (video_segment_tpu/core/flow.py, `_tvl1_scale`), and the port ran the
// same body as about 60 eager torch launches a primal-dual iteration
// (core/flow.py, `_tvl1_scale`, still the plain version).  Here one C call
// runs a whole scale: for each warp one launch of `tvl1_warp_kernel`, then
// one launch of `tvl1_iter_kernel` an iteration, all queued from C on the
// caller's stream (a ctypes call holds no Python lock while it runs).
//
// Arithmetic: each eager op rounds once, and so does each operation here,
// in the eager body's order (built with -fmad=false, so nothing is
// contracted into a fused multiply-add; IEEE division and `hypotf`, as
// torch's kernels use).  The scalars are the float32 casts of the Python
// doubles torch multiplies by: l_t, -l_t, taut, theta and the 1e-9 clamp.
// The fields then equal the eager ones bit for bit.
//
// What bounds it: bytes and, at the coarse scales, launch latency.  An
// iteration reads u1, u2, p11, p12, p21, p22 and the warp's invariants
// i1wx, i1wy, rho_c and writes the six state planes: 60 B a pixel, with
// about 20 float32 operations a pixel, far below the card's 67 TFLOP/s.
// At 272x480 a batch of six pairs makes 62.5 M pixel-iterations, 3.75 GB,
// 1.12 ms at 3.35 TB/s; the four coarse scales (136x240 down to 17x30)
// run 480 of a batch's 520 iterations on fewer pixels than the card has
// threads, so each of those launches costs its latency.  At the finest
// scale the invariants and one state buffer of six pairs come to about
// 28 MB, both state buffers to about 47 MB, close to the card's 50 MB L2:
// much of an iteration's traffic may stay in L2, so the HBM rate is a
// loose bound there.  The design does a whole iteration in one launch:
// a 32x8 tile loads p with a one-pixel halo into shared memory,
// recomputes the new u over the tile plus its right and bottom halo (the
// forward differences need them), and updates p at its own pixels.  Old
// and new state sit in two buffers, swapped every iteration, so no tile
// reads what another has written.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;                  // tile width (threads in x)
constexpr int TH = 8;                   // tile height (threads in y)
constexpr int THREADS = TW * TH;
constexpr int PW = TW + 2, PH = TH + 2;  // p with a one-pixel halo
constexpr int UW = TW + 1, UH = TH + 1;  // new u, tile plus right/bottom
constexpr int WARP_THREADS = 256;

struct Consts {
  float l_t;    // lambda * theta
  float nl_t;   // -(lambda * theta)
  float taut;   // tau / theta
  float theta;
  float gmin;   // the clamp of grad2 below the division
};

// torch.clamp(v, 0.0, 1.0) on the card.
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ long long clampi(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// `_warp` of i1, i1x and i1y at (x+u1, y+u2), then the loop invariants
// `grad2` (recomputed by each iteration, not stored) and
// rho_c = i1w - i1wx*u1 - i1wy*u2 - i0.
__global__ void __launch_bounds__(WARP_THREADS) tvl1_warp_kernel(
    const float* __restrict__ i0, const float* __restrict__ i1,
    const float* __restrict__ i1x, const float* __restrict__ i1y,
    const float* __restrict__ u1, const float* __restrict__ u2,
    float* __restrict__ i1wx_out, float* __restrict__ i1wy_out,
    float* __restrict__ rho_out, long long n, int H, int W) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long hw = (long long)H * W;
    const long long plane = i / hw * hw;
    const int y = (int)(i % hw / W);
    const int x = (int)(i % W);
    const float uu1 = u1[i];
    const float uu2 = u2[i];
    const float ys = (float)y + uu2;
    const float xs = (float)x + uu1;
    const long long y0 = clampi((long long)floorf(ys), H - 1);
    const long long x0 = clampi((long long)floorf(xs), W - 1);
    const long long y1 = clampi(y0 + 1, H - 1);
    const long long x1 = clampi(x0 + 1, W - 1);
    const float wy = clamp01(ys - (float)y0);
    const float wx = clamp01(xs - (float)x0);
    const float owy = 1.0f - wy;
    const float owx = 1.0f - wx;
    const long long k00 = plane + y0 * W + x0, k01 = plane + y0 * W + x1;
    const long long k10 = plane + y1 * W + x0, k11 = plane + y1 * W + x1;
    float s[3];
    const float* imgs[3] = {i1, i1x, i1y};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* im = imgs[c];
      s[c] = im[k00] * owy * owx + im[k01] * owy * wx + im[k10] * wy * owx +
             im[k11] * wy * wx;
    }
    i1wx_out[i] = s[1];
    i1wy_out[i] = s[2];
    rho_out[i] = s[0] - s[1] * uu1 - s[2] * uu2 - i0[i];
  }
}

// One primal-dual iteration: the thresholding step, the backward-difference
// divergence of the old p, the u update, the forward differences of the
// new u and the dual update of p.  `old_s` and `new_s` hold the planes
// u1, u2, p11, p12, p21, p22 (each B*H*W floats); `inv` i1wx, i1wy, rho_c.
__global__ void __launch_bounds__(THREADS) tvl1_iter_kernel(
    const float* __restrict__ old_s, float* __restrict__ new_s,
    const float* __restrict__ inv, long long n, int H, int W, Consts c) {
  __shared__ float sp[4][PH][PW];
  __shared__ float su[2][UH][UW];
  const long long plane = (long long)blockIdx.z * H * W;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const float* u1 = old_s + plane;
  const float* u2 = old_s + n + plane;
  const float* i1wx = inv + plane;
  const float* i1wy = inv + n + plane;
  const float* rho_c = inv + 2 * n + plane;

  // Old p over the tile and a one-pixel halo (zero outside the frame; the
  // divergence below never reads those).
  for (int k = tid; k < PH * PW; k += THREADS) {
    const int ly = k / PW, lx = k % PW;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const long long gi = plane + (long long)gy * W + gx;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sp[q][ly][lx] = in ? old_s[(2 + q) * n + gi] : 0.0f;
    }
  }
  __syncthreads();

  // New u over the tile plus its right column and bottom row.
  for (int k = tid; k < UH * UW; k += THREADS) {
    const int ly = k / UW, lx = k % UW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const long long gi = (long long)gy * W + gx;
    const float a = i1wx[gi], b = i1wy[gi];
    const float uo1 = u1[gi], uo2 = u2[gi];
    const float rho = rho_c[gi] + a * uo1 + b * uo2;
    const float grad2 = a * a + b * b;
    const float hi_t = c.l_t * grad2;
    const float lo_t = c.nl_t * grad2;
    const float g = isnan(grad2) ? grad2 : fmaxf(grad2, c.gmin);
    const float nrho = -rho;
    const bool lo = rho < lo_t, hi = rho > hi_t;
    const float d1 = lo ? c.l_t * a : (hi ? c.nl_t * a : nrho * a / g);
    const float d2 = lo ? c.l_t * b : (hi ? c.nl_t * b : nrho * b / g);
    const float v1 = uo1 + d1;
    const float v2 = uo2 + d2;
    // p at (gx, gy) is sp[.][ly + 1][lx + 1].
    const float div1 =
        ((gx < W - 1 ? sp[0][ly + 1][lx + 1] : 0.0f) -
         (gx >= 1 ? sp[0][ly + 1][lx] : 0.0f)) +
        ((gy < H - 1 ? sp[1][ly + 1][lx + 1] : 0.0f) -
         (gy >= 1 ? sp[1][ly][lx + 1] : 0.0f));
    const float div2 =
        ((gx < W - 1 ? sp[2][ly + 1][lx + 1] : 0.0f) -
         (gx >= 1 ? sp[2][ly + 1][lx] : 0.0f)) +
        ((gy < H - 1 ? sp[3][ly + 1][lx + 1] : 0.0f) -
         (gy >= 1 ? sp[3][ly][lx + 1] : 0.0f));
    const float un1 = v1 + c.theta * div1;
    const float un2 = v2 + c.theta * div2;
    su[0][ly][lx] = un1;
    su[1][ly][lx] = un2;
    if (ly < TH && lx < TW) {
      new_s[plane + gi] = un1;
      new_s[n + plane + gi] = un2;
    }
  }
  __syncthreads();

  const int lx = threadIdx.x, ly = threadIdx.y;
  const int gx = x0 + lx, gy = y0 + ly;
  if (gy >= H || gx >= W) return;
  const long long gi = plane + (long long)gy * W + gx;
  const float un1 = su[0][ly][lx], un2 = su[1][ly][lx];
  const float u1x = gx < W - 1 ? su[0][ly][lx + 1] - un1 : 0.0f;
  const float u1y = gy < H - 1 ? su[0][ly + 1][lx] - un1 : 0.0f;
  const float u2x = gx < W - 1 ? su[1][ly][lx + 1] - un2 : 0.0f;
  const float u2y = gy < H - 1 ? su[1][ly + 1][lx] - un2 : 0.0f;
  const float ng1 = 1.0f + c.taut * hypotf(u1x, u1y);
  const float ng2 = 1.0f + c.taut * hypotf(u2x, u2y);
  new_s[2 * n + gi] = (sp[0][ly + 1][lx + 1] + c.taut * u1x) / ng1;
  new_s[3 * n + gi] = (sp[1][ly + 1][lx + 1] + c.taut * u1y) / ng1;
  new_s[4 * n + gi] = (sp[2][ly + 1][lx + 1] + c.taut * u2x) / ng2;
  new_s[5 * n + gi] = (sp[3][ly + 1][lx + 1] + c.taut * u2y) / ng2;
}

}  // namespace

// One pyramid scale of B pairs of (H, W) float32 planes, all contiguous on
// the current device.  `state` holds 2 x 6 planes (u1, u2, p11, p12, p21,
// p22, twice), `inv` 3 planes.  u1 and u2 are copied into the first half
// and p set to 0; after `warps` x `iterations` iterations the result is in
// half (warps * iterations) % 2.  Returns the first CUDA error, else 0.
extern "C" int tvl1_scale(const void* i0, const void* i1, const void* i1x,
                          const void* i1y, const void* u1, const void* u2,
                          void* state, void* inv, int B, int H, int W,
                          int warps, int iterations, float l_t, float nl_t,
                          float taut, float theta, float gmin, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  const size_t bytes = (size_t)n * sizeof(float);
  float* s[2] = {(float*)state, (float*)state + 6 * n};
  float* iv = (float*)inv;
  cudaError_t e;
  if ((e = cudaMemcpyAsync(s[0], u1, bytes, cudaMemcpyDeviceToDevice, st)) ||
      (e = cudaMemcpyAsync(s[0] + n, u2, bytes, cudaMemcpyDeviceToDevice,
                           st)) ||
      (e = cudaMemsetAsync(s[0] + 2 * n, 0, 4 * bytes, st))) {
    return (int)e;
  }
  const Consts c{l_t, nl_t, taut, theta, gmin};
  const long long wblocks = (n + WARP_THREADS - 1) / WARP_THREADS;
  const int warp_grid = (int)(wblocks < 65536 ? wblocks : 65536);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const dim3 block(TW, TH);
  int cur = 0;
  for (int w = 0; w < warps; ++w) {
    tvl1_warp_kernel<<<warp_grid, WARP_THREADS, 0, st>>>(
        (const float*)i0, (const float*)i1, (const float*)i1x,
        (const float*)i1y, s[cur], s[cur] + n, iv, iv + n, iv + 2 * n, n, H,
        W);
    if ((e = cudaGetLastError())) return (int)e;
    for (int it = 0; it < iterations; ++it) {
      tvl1_iter_kernel<<<grid, block, 0, st>>>(s[cur], s[1 - cur], iv, n, H,
                                               W, c);
      if ((e = cudaGetLastError())) return (int)e;
      cur = 1 - cur;
    }
  }
  return 0;
}

// The iteration kernel's resources.  out: registers a thread, local
// (spill) bytes a thread, static and dynamic shared memory bytes a CTA,
// threads a CTA, resident CTAs an SM.
extern "C" int tvl1_resources(int* out) {
  const int smem = 0;
  cudaError_t e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, tvl1_iter_kernel);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, tvl1_iter_kernel,
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
