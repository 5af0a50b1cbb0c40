// Bilateral presmoothing filter (K6) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the filter as XLA ops
// (video_segment_tpu/ops/filters.py, `bilateral_filter`), and the port ran
// the same body as about 1,050 eager torch launches a frame
// (ops/filters.py, `bilateral_filter_plain`, still the CPU path).  Here one
// launch smooths a whole (H, W, 3) float32 frame.
//
// Arithmetic: the eager body rounds each op once, and so does each
// operation here, in the eager body's order (built with -fmad=false, so
// nothing is contracted into a fused multiply-add; IEEE division).  The
// eager body's `_fma(a, b, c)` widens its float32 operands to double,
// multiplies (exactly) and adds in double, and rounds the sum to float32:
// `fma64` below does the same.  That is not `fmaf`: rounding to double and
// then to float can differ from rounding once.  Per tap, in the order of
// `_circular_offsets` (dy, then dx): the channel differences s = c - nb,
// d2 = fma64(s2, s2, fma64(s0, s0, s1 * s1)), the weight
// xla_exp(d2 * color_coeff) * ws[tap] (XLA's polynomial step for step, as
// `ops/histograms.xla_exp`), the weight sum as plain adds, and each
// channel's value sum as fma64(w0, n0, w1 * n1), then one fma64 a tap.
// The spatial weights ws are the eager body's float32 constants, from the
// host.  The output then equals the eager body's bit for bit.
//
// What bounds it: float64 operations.  At radius 4 a pixel takes 49 taps
// of 14 emulated multiply-adds (a double multiply and add each), about
// 1,370 float64 operations: 0.18 G at 272x480, 5.2 us at 34 TFLOP/s.
// Bytes are 24 a pixel (3.1 MB, 0.9 us).  The widenings and roundings
// between float and double (about 35 a tap) issue at a quarter of the
// float64 rate, so they, not the arithmetic, set the time.  The design
// reads each input pixel once into shared memory: a 32x8 tile of threads,
// one a pixel and all three channels, loads its tile plus a `radius` halo
// (indices clamped to the frame, which is the eager replicate pad) as
// three planes, and runs the taps from there.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;                 // tile width (threads in x)
constexpr int TH = 8;                  // tile height (threads in y)
constexpr int THREADS = TW * TH;
constexpr int MAX_RADIUS = 16;         // the largest halo a launch takes
constexpr int MAIN_RADIUS = 4;         // the default sigma_space 3.0

// XLA's CPU `exp_f32`, constants as `ops/histograms.py` holds them.
constexpr float EXP_LO = -0x1.5f3334p+6f;
constexpr float EXP_HI = 0x1.633334p+6f;
constexpr double EXP_LOG2E = 0x1.715476p+0;
constexpr double EXP_C1 = 0x1.63p-1;
constexpr double EXP_C2 = -0x1.bd0106p-13;
constexpr double EXP_P0 = 0x1.a0d2cep-13;
constexpr double EXP_P1 = 0x1.6e879cp-10;
constexpr double EXP_P2 = 0x1.11121p-7;
constexpr double EXP_P3 = 0x1.555382p-5;
constexpr double EXP_P4 = 0x1.555554p-3;
constexpr double EXP_P5 = 0x1p-1;
constexpr float FLT_MIN_NORMAL = 0x1p-126f;

size_t smem_bytes(int radius) {
  return sizeof(float) * 3 * (TH + 2 * radius) * (TW + 2 * radius);
}

// The eager `_fma`: the operands as doubles (a float widens exactly), the
// product (exact for two floats) and the sum rounded to double, the sum
// then rounded to float32.
__device__ __forceinline__ float fma64(double a, double b, double c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// torch.clamp(v, lo, hi) on the card: NaN passes through.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// `ops/histograms.xla_exp`, op for op.
__device__ __forceinline__ float xla_exp(float x) {
  x = clampf(x, EXP_LO, EXP_HI);
  const float n = clampf(floorf(fma64(x, EXP_LOG2E, 0.5)), -127.0f, 127.0f);
  float r = fma64(n, -EXP_C1, x);
  r = fma64(n, -EXP_C2, r);
  float y = (float)EXP_P0;
  y = fma64(y, r, EXP_P1);
  y = fma64(y, r, EXP_P2);
  y = fma64(y, r, EXP_P3);
  y = fma64(y, r, EXP_P4);
  y = fma64(y, r, EXP_P5);
  y = fma64(y, r * r, r) + 1.0f;
  const float out = y * __int_as_float(((int)n + 127) << 23);
  return out < FLT_MIN_NORMAL ? 0.0f : out;
}

// One (H, W, 3) float32 frame.  `ws` holds the spatial weight of each tap
// within `radius`, in tap order; `color_coeff` is -0.5 / sigma_color^2
// rounded to float32, as torch rounds the scalar it multiplies by.
__global__ void __launch_bounds__(THREADS) bilateral_kernel(
    const float* __restrict__ img, float* __restrict__ out,
    const float* __restrict__ ws, int H, int W, int radius,
    float color_coeff) {
  extern __shared__ float tile[];   // 3 planes of (TH + 2r) x (TW + 2r)
  const int pw = TW + 2 * radius;
  const int plane = pw * (TH + 2 * radius);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int k = tid; k < plane; k += THREADS) {
    const int gy = min(max(y0 - radius + k / pw, 0), H - 1);
    const int gx = min(max(x0 - radius + k % pw, 0), W - 1);
    const float* p = img + ((long long)gy * W + gx) * 3;
    tile[k] = p[0];
    tile[plane + k] = p[1];
    tile[2 * plane + k] = p[2];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ck = (threadIdx.y + radius) * pw + threadIdx.x + radius;
  const float c0 = tile[ck], c1 = tile[plane + ck], c2 = tile[2 * plane + ck];
  float wsum = 0.0f, v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
  float wf = 0.0f, nf0 = 0.0f, nf1 = 0.0f, nf2 = 0.0f;   // the first tap
  const int rr = radius * radius;
  int t = 0;
  for (int dy = -radius; dy <= radius; ++dy) {
    for (int dx = -radius; dx <= radius; ++dx) {
      if (dy * dy + dx * dx > rr) continue;
      const int k = ck + dy * pw + dx;
      const float n0 = tile[k], n1 = tile[plane + k], n2 = tile[2 * plane + k];
      const float s0 = c0 - n0, s1 = c1 - n1, s2 = c2 - n2;
      const float d2 = fma64(s2, s2, fma64(s0, s0, s1 * s1));
      const float wt = xla_exp(d2 * color_coeff) * __ldg(ws + t);
      if (t == 0) {
        wsum = wt;
        wf = wt;
        nf0 = n0;
        nf1 = n1;
        nf2 = n2;
      } else if (t == 1) {
        wsum = wsum + wt;
        v0 = fma64(wf, nf0, wt * n0);
        v1 = fma64(wf, nf1, wt * n1);
        v2 = fma64(wf, nf2, wt * n2);
      } else {
        wsum = wsum + wt;
        v0 = fma64(wt, n0, v0);
        v1 = fma64(wt, n1, v1);
        v2 = fma64(wt, n2, v2);
      }
      ++t;
    }
  }
  // torch.clamp(wsum, min=1e-20), then IEEE division.
  const float den = isnan(wsum) ? wsum : fmaxf(wsum, (float)1e-20);
  float* o = out + ((long long)y * W + x) * 3;
  o[0] = v0 / den;
  o[1] = v1 / den;
  o[2] = v2 / den;
}

}  // namespace

// One contiguous (H, W, 3) float32 frame `img` into `out` (the same shape)
// on the current device, queued on `stream`.  `ws` holds the taps' spatial
// weights (float32, on the device).  Returns the CUDA error of the launch,
// else 0.
extern "C" int bilateral_filter(const void* img, void* out, const void* ws,
                                int H, int W, int radius, float color_coeff,
                                void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (radius < 1 || radius > MAX_RADIUS) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  bilateral_kernel<<<grid, dim3(TW, TH), smem_bytes(radius),
                     (cudaStream_t)stream>>>(
      (const float*)img, (float*)out, (const float*)ws, H, W, radius,
      color_coeff);
  return (int)cudaGetLastError();
}

// The kernel's resources at the main path's radius.  out: registers a
// thread, local (spill) bytes a thread, static and dynamic shared memory
// bytes a CTA, threads a CTA, resident CTAs an SM.
extern "C" int bilateral_resources(int* out) {
  const int smem = (int)smem_bytes(MAIN_RADIUS);
  cudaError_t e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, bilateral_kernel);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, bilateral_kernel,
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
