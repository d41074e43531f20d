// Per-row delta statistics, int8 quantization and an exact dirty flag for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/block_delta/kernel.py
// (`block_delta`, body `_delta_kernel`). A flat leaf of n float32 or bf16
// elements is cut into rows of `be` elements (the last row padded with
// zeros on both sides, what `blockify` gives). For each row, with
// d = f32(new) - f32(old):
//   norm2 = sum(d*d), maxabs = max|d| (NaN if any d is NaN),
//   scale = maxabs > 0 ? maxabs / 127 : 1,
//   q = int8(clip(round(d / scale), -127, 127)), rounding half to even, and
//       0 where d / scale is NaN (a NaN delta, inf / inf, 0 / 0),
//   dirty = any element's bit pattern differs between new and old.
// Subnormal inputs and results are flushed to zero (the `.ftz` forms of
// sub, mul, add, div), as XLA flushes them on the CPU and the TPU, so
// norm2, scale and q equal the reference's on subnormal rows too. The
// dirty flag sees every change of bits, also those (sign of a zero, NaN
// payloads, finite -> NaN, subnormal or underflowing deltas) that leave
// norm2 at 0 or NaN and q at 0.
//
// Bound. The function reads new and old once and writes q once, plus 9
// bytes per row: 9 bytes per float32 element, 5 per bf16 one. The
// arithmetic is a few operations per element, far below the 67 TFLOP/s
// float32 rate, so bytes bound it (4.1 ms over qwen2-1.5b's 8 leaves of at
// least one 256 KiB row at 3.35 TB/s).
//
// Design. On the serving path a row is one 256 KiB FaaSFS block (65,536
// float32): its d takes 256 KiB, more than a block's 227 KB of shared
// memory or an SM's register file, while scale needs the whole row's max
// before any q. `delta_cluster_kernel` splits the row over a thread-block
// cluster of C blocks on neighbouring SMs (C = ceil(be / (threads * 16)),
// at most 16; 256 threads and C = 16 for the serving rows): each thread
// stages 16 elements of new and old with 16-byte cp.async copies
// (neighbouring threads on neighbouring addresses, into the thread's own
// shared-memory slots, so no register waits on them) and keeps its 16
// values of d in registers. The block reduces its (sum d^2, max|d|, any
// bits differ) with warp shuffles and shared memory, and sends the triple
// to every block of the cluster through distributed shared memory
// (st.async, completing on the receiver's mbarrier), so all compute the
// same scale by IEEE division. Each block then quantizes from registers
// (IEEE division, never a multiply by 1/scale; rintf) and stores its q
// with one 4-byte (float32) or 8-byte (bf16) store per 16-byte load, each
// warp instruction writing whole 128- or 256-byte lines. So each element
// is read once. The cluster meets twice: once while the copies are in
// flight (after the barriers are initialised, before any triple is sent)
// and once before exit. Reading the triples with `map_shared_rank` after
// a cluster barrier, where nothing is in flight, is simpler and was timed
// about 15% slower on the H100 (PERF.md, Findings).
//
// `delta_two_pass_kernel` covers the rows the cluster kernel does not
// take: rows longer than 16 blocks of 1,024 threads x 16 values, rows
// whose length is not a whole number of 16-byte loads, and inputs not
// aligned to 16 bytes. One 1024-thread block owns a row and reads it twice
// (pass 1 reduces, pass 2 quantizes), about 17 bytes per float32 element
// at serving rows. Compile without --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int VPT = 16;         // values of d per thread in the cluster kernel
constexpr int MAX_CLUSTER = 16; // non-portable above 8
constexpr int NT2 = 1024;       // threads of the two-pass kernel

__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float div_ftz(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// max that returns NaN if either operand is NaN (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int quantize(float d, float sc) {
  const float x = div_ftz(d, sc);
  if (isnan(x)) return 0;
  return (int)fminf(fmaxf(rintf(x), -127.f), 127.f);
}

__device__ __forceinline__ float row_scale(float maxabs) {
  return maxabs > 0.f ? div_ftz(maxabs, 127.0f) : 1.0f;
}

// Element types by their bits: `Raw` is loaded and compared, `f32` widens.
struct F32 {
  using Raw = uint32_t;
  static __device__ __forceinline__ float f32(uint32_t b) { return __uint_as_float(b); }
};
struct BF16 {
  using Raw = uint16_t;
  static __device__ __forceinline__ float f32(uint32_t b) { return __uint_as_float(b << 16); }
};

// Element k (of 16 / sizeof(Raw)) of a 16-byte vector, as its bits.
template <typename T>
__device__ __forceinline__ uint32_t lane_bits(const uint4& v, int k) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (sizeof(typename T::Raw) == 4) return w[k];
  return (w[k >> 1] >> (16 * (k & 1))) & 0xffffu;
}

// Sum, NaN-propagating max and OR over the warp.
__device__ __forceinline__ void warp_reduce(float& s2, float& mx, unsigned& df) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s2 = add_ftz(s2, __shfl_xor_sync(0xffffffffu, s2, off));
    mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    df |= __shfl_xor_sync(0xffffffffu, df, off);
  }
}

// Reduce a block's per-thread triples; thread 0 gets the block's.
template <int NT>
__device__ __forceinline__ void block_reduce(float& s2, float& mx, unsigned& df) {
  __shared__ float red_s[NT / 32];
  __shared__ float red_m[NT / 32];
  __shared__ unsigned red_d[NT / 32];
  const int tid = threadIdx.x;
  warp_reduce(s2, mx, df);
  if ((tid & 31) == 0) {
    red_s[tid >> 5] = s2;
    red_m[tid >> 5] = mx;
    red_d[tid >> 5] = df;
  }
  __syncthreads();
  if (tid < 32) {
    s2 = tid < NT / 32 ? red_s[tid] : 0.f;
    mx = tid < NT / 32 ? red_m[tid] : 0.f;
    df = tid < NT / 32 ? red_d[tid] : 0u;
    warp_reduce(s2, mx, df);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; bytes past `src_bytes` are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of the given parity has completed; traps after
// 2^28 polls rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// 16 bytes into block `rank`'s shared memory at the address `local` has in
// this block, completing their byte count on that block's barrier `bar`.
__device__ __forceinline__ void st_async_remote(const void* local, const uint64_t* bar,
                                                uint32_t rank, uint4 v) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar)
      : "memory");
}

// Start copying this block's share of row `row` (elements [rank * NT * VPT,
// (rank + 1) * NT * VPT) of the row) into the thread's own slots of `stage`:
// vector j of new at stage[j * NT + tid], of old at stage[(L + j) * NT + tid].
// Elements at or past n, and past the row's end, arrive as zeros.
template <typename T, int NT>
__device__ __forceinline__ void stage_share(uint4* stage, const typename T::Raw* nw,
                                            const typename T::Raw* od, int64_t row, int rank,
                                            int64_t n, int64_t be) {
  constexpr int E = 16 / sizeof(typename T::Raw);
  constexpr int L = VPT / E;
  const int64_t row_end = (row + 1) * be;
  const int64_t load_end = row_end < n ? row_end : n;
  const int64_t lo = row * be + (int64_t)rank * NT * VPT;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int64_t i = lo + ((int64_t)j * NT + threadIdx.x) * E;
    const int64_t left = load_end - i;
    const int bytes = left >= E ? 16 : left > 0 ? (int)left * (int)sizeof(typename T::Raw) : 0;
    cp_async16(&stage[j * NT + threadIdx.x], bytes ? nw + i : nw, bytes);
    cp_async16(&stage[(L + j) * NT + threadIdx.x], bytes ? od + i : od, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One row per cluster of C blocks; block `rank` owns elements
// [rank * NT * VPT, (rank + 1) * NT * VPT) of the row. The block starts
// staging its share by cp.async into its threads' own shared-memory slots
// (registers stay free for d, so five 256-thread blocks fit on an SM),
// and while the copies fly, initialises its barrier and meets the cluster
// once, so that no triple can reach a barrier not yet initialised. It
// then takes d into registers, reduces (sum d^2, max|d|, bits differ)
// over the block, and sends the triple to every block of the cluster with
// st.async, which completes on the receiver's barrier; it waits there for
// the C triples, computes scale, and quantizes from registers. The
// cluster meets a second time before exit, so no block leaves while a
// triple may still be on its way to it.
template <typename T, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
delta_cluster_kernel(const typename T::Raw* __restrict__ nw,
                     const typename T::Raw* __restrict__ od, int8_t* __restrict__ q,
                     float* __restrict__ norm2, float* __restrict__ scale,
                     uint8_t* __restrict__ dirty, int64_t n, int64_t be, int C) {
  using Raw = typename T::Raw;
  constexpr int E = 16 / sizeof(Raw);   // elements per 16-byte vector
  constexpr int L = VPT / E;            // vectors per input and thread
  // 2 * L * NT vectors. 128-byte aligned: at the 16-byte alignment that the
  // static arrays before it leave, the kernel ran about 30% slower.
  extern __shared__ __align__(128) uint4 stage[];
  __shared__ uint4 inbox[MAX_CLUSTER];  // the cluster's (sum d^2, max|d|, bits differ)
  __shared__ uint64_t full;             // completes when all C triples landed
  __shared__ float sc_s;

  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / C;

  stage_share<T, NT>(stage, nw, od, row, rank, n, be);
  if (tid == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();
  if (tid == 0) mbar_expect_tx(&full, 16u * C);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  float d[VPT];
  float s2 = 0.f, mx = 0.f;
  unsigned df = 0u;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint4 a = stage[j * NT + tid], b = stage[(L + j) * NT + tid];
    df |= (a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float v = sub_ftz(T::f32(lane_bits<T>(a, k)), T::f32(lane_bits<T>(b, k)));
      d[j * E + k] = v;
      s2 = add_ftz(s2, mul_ftz(v, v));
      mx = max_nan(mx, fabsf(v));
    }
  }

  block_reduce<NT>(s2, mx, df);
  if (tid < 32) {   // every lane of warp 0 holds the block's triple
    if (tid < C)
      st_async_remote(&inbox[rank], &full, tid,
                      make_uint4(__float_as_uint(s2), __float_as_uint(mx), df, 0u));
    mbar_wait(&full, 0);
    float ts = 0.f, tm = 0.f;
    unsigned td = 0u;
    if (tid < C) {
      const uint4 t = inbox[tid];
      ts = __uint_as_float(t.x);
      tm = __uint_as_float(t.y);
      td = t.z;
    }
    warp_reduce(ts, tm, td);
    if (tid == 0) {
      const float sc = row_scale(tm);
      sc_s = sc;
      if (rank == 0) {
        norm2[row] = ts;
        scale[row] = sc;
        dirty[row] = td != 0u;
      }
    }
  }
  __syncthreads();

  const float sc = sc_s;
  const int64_t row_end = (row + 1) * be;
  const int64_t lo = row * be + (int64_t)rank * NT * VPT;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int64_t i = lo + ((int64_t)j * NT + tid) * E;
    if (i >= row_end) continue;
    uint32_t w[E / 4];
#pragma unroll
    for (int k = 0; k < E / 4; ++k) w[k] = 0u;
#pragma unroll
    for (int k = 0; k < E; ++k)
      w[k >> 2] |= (uint32_t)(quantize(d[j * E + k], sc) & 0xff) << (8 * (k & 3));
    if constexpr (E == 4) {
      __stcs(reinterpret_cast<unsigned int*>(q + i), w[0]);
    } else {
      __stcs(reinterpret_cast<uint2*>(q + i), make_uint2(w[0], w[1]));
    }
  }
  cluster.sync();
}

// One 1024-thread block per row, reading it twice; any alignment and length.
template <typename T>
__global__ void __launch_bounds__(NT2)
delta_two_pass_kernel(const typename T::Raw* __restrict__ nw,
                      const typename T::Raw* __restrict__ od, int8_t* __restrict__ q,
                      float* __restrict__ norm2, float* __restrict__ scale,
                      uint8_t* __restrict__ dirty, int64_t n, int64_t be) {
  __shared__ float sc_s;
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * be;
  const int64_t valid = n - base < be ? n - base : be;   // elements not padding

  float s2 = 0.f, mx = 0.f;
  unsigned df = 0u;
  for (int64_t i = tid; i < valid; i += NT2) {
    const uint32_t ra = nw[base + i], rb = od[base + i];
    df |= ra ^ rb;
    const float v = sub_ftz(T::f32(ra), T::f32(rb));
    s2 = add_ftz(s2, mul_ftz(v, v));
    mx = max_nan(mx, fabsf(v));
  }
  block_reduce<NT2>(s2, mx, df);
  if (tid == 0) {
    const float sc = row_scale(mx);
    sc_s = sc;
    norm2[blockIdx.x] = s2;
    scale[blockIdx.x] = sc;
    dirty[blockIdx.x] = df != 0u;
  }
  __syncthreads();

  const float sc = sc_s;
  for (int64_t i = tid; i < be; i += NT2) {
    const float v = i < valid ? sub_ftz(T::f32(nw[base + i]), T::f32(od[base + i])) : 0.f;
    q[base + i] = (int8_t)quantize(v, sc);
  }
}

template <typename T, int NT>
cudaError_t launch_cluster(const void* nw, const void* od, void* q, void* norm2, void* scale,
                           void* dirty, int64_t n, int64_t be, int64_t nb, int C,
                           cudaStream_t stream) {
  auto kernel = delta_cluster_kernel<T, NT>;
  const int smem = 2 * VPT * NT * (int)sizeof(typename T::Raw);
  // Set on every launch: the attributes belong to the current device's context.
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nb * C));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using Raw = typename T::Raw;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const Raw*>(nw),
                                     static_cast<const Raw*>(od), static_cast<int8_t*>(q),
                                     static_cast<float*>(norm2), static_cast<float*>(scale),
                                     static_cast<uint8_t*>(dirty), n, be, C);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cluster_nt(const void* nw, const void* od, void* q, void* norm2,
                              void* scale, void* dirty, int64_t n, int64_t be, int64_t nb,
                              int threads, cudaStream_t stream) {
  if (threads != 256 && threads != 512 && threads != 1024) return cudaErrorInvalidValue;
  const int64_t C = (be + (int64_t)threads * VPT - 1) / ((int64_t)threads * VPT);
  if (C > MAX_CLUSTER || nb * C > 0x7fffffffLL) return cudaErrorInvalidValue;
  switch (threads) {
    case 256:
      return launch_cluster<T, 256>(nw, od, q, norm2, scale, dirty, n, be, nb, (int)C, stream);
    case 512:
      return launch_cluster<T, 512>(nw, od, q, norm2, scale, dirty, n, be, nb, (int)C, stream);
    default:
      return launch_cluster<T, 1024>(nw, od, q, norm2, scale, dirty, n, be, nb, (int)C, stream);
  }
}

bool valid_args(int64_t n, int64_t be, int64_t* nb) {
  if (n <= 0 || be <= 0) return false;
  *nb = (n + be - 1) / be;
  return *nb <= 0x7fffffffLL;
}

}  // namespace

// new and old: n contiguous elements of one type (dtype 0 float32, 1
// bf16), read as rows of `be`, the last padded with zeros. q (nb, be)
// int8, norm2 and scale (nb,) float32, dirty (nb,) one byte each, with
// nb = ceil(n / be). Each entry returns cudaGetLastError() after its
// launch (or the launch's own error).
//
// The cluster kernel, `threads` per block (256, 512 or 1024), 16 values per
// thread, C = ceil(be / (threads * 16)) <= 16 blocks per row. Needs new and
// old aligned to 16 bytes and be a multiple of 16 bytes of input (4
// float32, 8 bf16); q is then aligned for its 4- or 8-byte stores.
extern "C" int repro_block_delta_cluster(const void* nw, const void* od, void* q, void* norm2,
                                         void* scale, void* dirty, int64_t n, int64_t be,
                                         int dtype, int threads, void* stream) {
  int64_t nb;
  if (!valid_args(n, be, &nb)) return (int)cudaErrorInvalidValue;
  const int elem = dtype == 0 ? 4 : 2;
  if ((be * elem) % 16 != 0 || (reinterpret_cast<uintptr_t>(nw) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(od) & 15) != 0 || (reinterpret_cast<uintptr_t>(q) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_cluster_nt<F32>(nw, od, q, norm2, scale, dirty, n, be, nb, threads, s);
  if (dtype == 1) return (int)launch_cluster_nt<BF16>(nw, od, q, norm2, scale, dirty, n, be, nb, threads, s);
  return (int)cudaErrorInvalidValue;
}

// The two-pass kernel: any be, any alignment.
extern "C" int repro_block_delta_two_pass(const void* nw, const void* od, void* q, void* norm2,
                                          void* scale, void* dirty, int64_t n, int64_t be,
                                          int dtype, void* stream) {
  int64_t nb;
  if (!valid_args(n, be, &nb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    delta_two_pass_kernel<F32><<<(unsigned)nb, NT2, 0, s>>>(
        static_cast<const uint32_t*>(nw), static_cast<const uint32_t*>(od),
        static_cast<int8_t*>(q), static_cast<float*>(norm2), static_cast<float*>(scale),
        static_cast<uint8_t*>(dirty), n, be);
  } else if (dtype == 1) {
    delta_two_pass_kernel<BF16><<<(unsigned)nb, NT2, 0, s>>>(
        static_cast<const uint16_t*>(nw), static_cast<const uint16_t*>(od),
        static_cast<int8_t*>(q), static_cast<float*>(norm2), static_cast<float*>(scale),
        static_cast<uint8_t*>(dirty), n, be);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
