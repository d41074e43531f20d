// Per-block delta statistics and int8 quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/block_delta/kernel.py
// (`block_delta`, body `_delta_kernel`). For each row of an
// (nblocks, block_elems) pair of float32 or bf16 arrays, with
// d = f32(new) - f32(old):
//   norm2 = sum(d*d), maxabs = max|d|,
//   scale = maxabs / 127 (1.0 when maxabs is 0),
//   q = int8(clip(round(d / scale), -127, 127)), rounding half to even.
//
// Design. The TPU kernel holds a whole row in VMEM for one grid step. On
// the serving path a row is one 256 KiB FaaSFS block (65,536 float32),
// more than the 227 KB of shared memory a Hopper block may use, so one
// 1024-thread block owns one row and reads it twice: pass 1 reduces norm2
// and maxabs (per thread, then warp shuffles, then across warps through
// shared memory); pass 2 recomputes d, divides by scale with IEEE division
// (never a multiply by 1/scale) and rounds with rintf, so q equals the
// plain version's int8 exactly. Compile without --use_fast_math.
//
// Bound. The function must read new and old once and write q, norm2 and
// scale once: 9 bytes per float32 element. Over the 8 eligible float32
// leaves of qwen2-1.5b (1.54 G elements, 13.9 GB) that is 4.1 ms at
// 3.35 TB/s; the arithmetic is a few operations per element, far below the
// 67 TFLOP/s float32 rate, so bytes bound it. This kernel reads the inputs
// twice (pass 2 finds part of the row in L2), so it moves up to 1.9x the
// bound's bytes; keeping the row in registers between the passes is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NT)
block_delta_kernel(const T* __restrict__ nw, const T* __restrict__ od,
                   int8_t* __restrict__ q, float* __restrict__ norm2,
                   float* __restrict__ scale, int64_t be) {
  __shared__ float red_s[NT / 32];
  __shared__ float red_m[NT / 32];
  __shared__ float row_scale;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * be;
  const T* a = nw + base;
  const T* b = od + base;

  float s2 = 0.f, mx = 0.f;
  for (int64_t i = tid; i < be; i += NT) {
    const float d = to_f32(a[i]) - to_f32(b[i]);
    s2 += d * d;
    mx = fmaxf(mx, fabsf(d));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if ((tid & 31) == 0) {
    red_s[tid >> 5] = s2;
    red_m[tid >> 5] = mx;
  }
  __syncthreads();
  if (tid < 32) {
    s2 = red_s[tid];
    mx = red_m[tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (tid == 0) {
      const float sc = mx > 0.f ? mx / 127.0f : 1.0f;
      row_scale = sc;
      norm2[blockIdx.x] = s2;
      scale[blockIdx.x] = sc;
    }
  }
  __syncthreads();

  const float sc = row_scale;
  int8_t* qr = q + base;
  for (int64_t i = tid; i < be; i += NT) {
    const float d = to_f32(a[i]) - to_f32(b[i]);
    const float r = fminf(fmaxf(rintf(d / sc), -127.f), 127.f);
    qr[i] = (int8_t)r;
  }
}

template <typename T>
cudaError_t launch(const void* nw, const void* od, void* q, void* norm2, void* scale,
                   int64_t nb, int64_t be, cudaStream_t stream) {
  block_delta_kernel<T><<<(unsigned)nb, NT, 0, stream>>>(
      static_cast<const T*>(nw), static_cast<const T*>(od), static_cast<int8_t*>(q),
      static_cast<float*>(norm2), static_cast<float*>(scale), be);
  return cudaGetLastError();
}

}  // namespace

// new and old (nb, be), contiguous, of one type: dtype 0 is float32, 1 is
// bf16. q (nb, be) int8, norm2 and scale (nb,) float32. Returns
// cudaGetLastError() after the launch.
extern "C" int repro_block_delta_fwd(const void* nw, const void* od, void* q, void* norm2,
                                     void* scale, int64_t nb, int64_t be, int dtype,
                                     void* stream) {
  if (nb <= 0 || be <= 0 || nb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(nw, od, q, norm2, scale, nb, be, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(nw, od, q, norm2, scale, nb, be, s);
  return (int)cudaErrorInvalidValue;
}
