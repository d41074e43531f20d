// Helpers shared by the selective-scan forward (ssm_scan.cu) and backward
// (ssm_scan_bwd.cu) kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

// Steps per staged chunk. The forward saves h at the start of every chunk
// of T steps; the backward recomputes each chunk's states from there, so
// both kernels must stage the same chunks.
constexpr int T = 64;
static_assert(T % 4 == 0, "T must be a multiple of 4");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename Tx> __device__ __forceinline__ Tx from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// How a channel's N states are split over threads: TPC threads per
// channel, SPT states each.
template <int N>
struct Split {
  static constexpr int TPC = N < 4 ? N : 4;   // threads per channel
  static constexpr int SPT = N / TPC;         // states per thread
};

// SPT floats of shared memory (16-byte aligned when SPT % 4 == 0).
template <int SPT>
__device__ __forceinline__ void load_states(float (&v)[SPT], const float* p) {
  if constexpr (SPT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < SPT; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x, v[j + 1] = f.y, v[j + 2] = f.z, v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) v[j] = p[j];
  }
}

template <int SPT>
__device__ __forceinline__ void store_states(float* p, const float (&v)[SPT]) {
  if constexpr (SPT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < SPT; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < SPT; ++j) p[j] = v[j];
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace scan
