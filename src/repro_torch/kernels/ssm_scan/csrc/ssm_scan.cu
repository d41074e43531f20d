// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py (`ssm_scan`,
// body `_ssm_kernel`). For x, dt (B, S, Di), B_, C (B, S, N), A (Di, N)
// negative and D (Di,), with h (B, Di, N) float32 starting at h0 (or 0):
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = sum_n h_t * C_t + D * x_t
// y has x's type (float32 or bf16); the last h is written as float32.
//
// Design. The TPU kernel carries h in VMEM scratch across a sequential
// grid axis of sequence chunks. A Hopper grid has no sequential axis, so
// each thread owns one (batch, channel d, state n), keeps its h in a
// register and walks the whole sequence itself; the N threads of a channel
// are N neighbouring lanes of one warp and sum h * C over n with a
// butterfly of warp shuffles. At the hymba-1.5b serving shape (B 4, Di
// 3200, N 16) that is 204,800 threads, enough to fill the card, and the
// loads of step t+1 are issued before step t's arithmetic. x, dt, B_ and C
// are read once from device memory (the lanes of a channel share each x
// and dt load), y and the last h written once. Any S and any Di work: the
// grid covers Di with a ragged last block whose spare lanes run the loop
// on a clamped channel and store nothing. N must be a power of two <= 32.
//
// Bound. Per launch the function must move x, dt, y, B_, C, A, D and the
// last h: 53.5 MB at the serving shape, 16 us at 3.35 TB/s; its ~0.7 GFLOP
// take 10.5 us at 67 TFLOP/s, so bytes bound it. It also takes one expf
// per (b, t, d, n), 104.9 M at that shape, which the special-function
// units cannot issue in much under 30 us. Compile without
// --use_fast_math: the plain version uses IEEE expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int N>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_last, int S, int Di) {
  constexpr int CH = NT / N;                    // channels per block
  const int n = threadIdx.x % N;
  const int d = blockIdx.x * CH + threadIdx.x / N;
  const int b = blockIdx.y;
  const bool live = d < Di;
  const int dd = live ? d : Di - 1;             // spare lanes shadow the last channel

  const float an = a[(int64_t)dd * N + n];
  const float dk = dskip[dd];
  const int64_t hidx = ((int64_t)b * Di + dd) * N + n;
  float h = h0 != nullptr ? h0[hidx] : 0.f;

  const int64_t xbase = (int64_t)b * S * Di + dd;   // + t * Di
  const int64_t bbase = (int64_t)b * S * N + n;     // + t * N
  float xn = 0.f, dtn = 0.f, bn = 0.f, cn = 0.f;
  if (S > 0) {
    xn = to_f32(x[xbase]);
    dtn = dt[xbase];
    bn = bm[bbase];
    cn = cm[bbase];
  }
  for (int t = 0; t < S; ++t) {
    const float xt = xn, dtt = dtn, bt = bn, ct = cn;
    if (t + 1 < S) {
      const int64_t xo = xbase + (int64_t)(t + 1) * Di;
      const int64_t bo = bbase + (int64_t)(t + 1) * N;
      xn = to_f32(x[xo]);
      dtn = dt[xo];
      bn = bm[bo];
      cn = cm[bo];
    }
    const float abar = expf(dtt * an);
    h = abar * h + (dtt * xt) * bt;
    float p = h * ct;
#pragma unroll
    for (int off = N / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
    if (live && n == 0) store(y + xbase + (int64_t)t * Di, p + dk * xt);
  }
  if (live) h_last[hidx] = h;
}

template <typename T, int N>
cudaError_t launch_n(const void* x, const void* dt, const void* bm, const void* cm,
                     const void* a, const void* dskip, const void* h0, void* y, void* h_last,
                     int B, int S, int Di, cudaStream_t stream) {
  constexpr int CH = NT / N;
  const dim3 grid((unsigned)((Di + CH - 1) / CH), (unsigned)B);
  ssm_scan_kernel<T, N><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dskip),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(h_last), S, Di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* bm, const void* cm,
                   const void* a, const void* dskip, const void* h0, void* y, void* h_last,
                   int B, int S, int Di, int N, cudaStream_t s) {
  switch (N) {
    case 1: return launch_n<T, 1>(x, dt, bm, cm, a, dskip, h0, y, h_last, B, S, Di, s);
    case 2: return launch_n<T, 2>(x, dt, bm, cm, a, dskip, h0, y, h_last, B, S, Di, s);
    case 4: return launch_n<T, 4>(x, dt, bm, cm, a, dskip, h0, y, h_last, B, S, Di, s);
    case 8: return launch_n<T, 8>(x, dt, bm, cm, a, dskip, h0, y, h_last, B, S, Di, s);
    case 16: return launch_n<T, 16>(x, dt, bm, cm, a, dskip, h0, y, h_last, B, S, Di, s);
    case 32: return launch_n<T, 32>(x, dt, bm, cm, a, dskip, h0, y, h_last, B, S, Di, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x and y (B, S, Di) of one type, dtype 0 float32 or 1 bf16; dt (B, S, Di),
// b and c (B, S, N), a (Di, N), d (Di,), h0 (B, Di, N) or null, h_last
// (B, Di, N): all float32 and contiguous. Returns cudaGetLastError() after
// the launch.
extern "C" int repro_ssm_scan_fwd(const void* x, const void* dt, const void* b, const void* c,
                                  const void* a, const void* d, const void* h0, void* y,
                                  void* h_last, int B, int S, int Di, int N, int dtype,
                                  void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, dt, b, c, a, d, h0, y, h_last, B, S, Di, N, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, b, c, a, d, h0, y, h_last, B, S, Di, N, s);
  return (int)cudaErrorInvalidValue;
}
