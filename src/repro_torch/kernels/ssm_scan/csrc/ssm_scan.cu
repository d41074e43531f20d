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
// grid axis of sequence chunks and stages (chunk, block_d) tiles of x and
// dt in VMEM. Here a block owns CH consecutive channels of one batch row
// and walks the sequence itself in chunks of T steps. Each chunk's x and dt
// (T x CH) and B_ and C (T x N) are copied into shared memory with 16-byte
// cp.async, double-buffered, so chunk k+1 is in flight while chunk k runs
// and every row of a copy is CH contiguous channels (128 bytes of bf16 x at
// CH 64). Each thread owns one channel and N / TPC of its states in
// registers (TPC = min(N, 4) threads per channel): the states are
// independent recurrences, and the sum over n takes a shuffle of at most
// two levels. Steps run in groups of U: the group's operands are read
// first and its y written last, so one step's expf, FMAs and shuffles
// overlap the next's (a shared-memory store between steps would order
// every later load after it). y of the chunk is written into x's slot in
// shared memory (same type) and copied out coalesced.
// The staged copies need Di % 8 == 0, N % 4 == 0 and 16-byte aligned
// tensors (the serving shapes); any other S, Di or N takes the same
// recurrence with element-wise synchronous copies. Any S and any Di work:
// the last block's spare channels and the last chunk's spare steps are
// computed on but never stored. Under autograd the launch also writes the
// state entering each chunk (h_chunks, (B, ceil(S / T), Di, N) float32,
// 6.6 MB at hymba-1.5b's training shape), from which the backward kernel
// (ssm_scan_bwd.cu) recomputes each chunk; serving passes null and skips
// those stores.
//
// Bound. Per launch the function must move x, dt, y, B_, C, A, D and the
// last h: 53.7 MB at the hymba-1.5b serving shape (B 4, S 512, Di 3200,
// N 16, x bf16), 16 us at 3.35 TB/s; its ~0.75 GFLOP take 11 us at
// 67 TFLOP/s, so bytes bound it. It also takes one expf per (b, t, d, n),
// 104.9 M at that shape, which the special-function units cannot issue in
// under 25 us. On an H100 (700 W) it takes about 0.093 ms there
// (chip_smoke.py). Block shapes from 16 to 128 channels and chunks of 32
// to 64 steps time about the same, so neither the copies nor the spread of
// blocks over SMs holds it back. The instructions do: about a dozen per
// (b, t, d, n) with the IEEE expf, from 12 warps per SM, which hide only
// part of a step's dependent expf, FMA and shuffle latency; grouping the
// steps (U) is what hid most of it. Compile without --use_fast_math: the
// plain version uses IEEE expf.

#include "scan_common.cuh"

namespace {

using scan::T;
using scan::Split;
using scan::to_f32;
using scan::from_f32;
using scan::cp_async16;
using scan::cp_async_commit;
using scan::cp_async_wait;
using scan::load_states;
using scan::aligned16;

constexpr int CH = 64;    // channels per block
constexpr int U = 8;      // steps whose loads are issued together
static_assert(CH % 8 == 0, "CH must be a multiple of 8");

template <typename Tx, int N>
__host__ __device__ constexpr int stage_bytes() {
  return T * CH * (int)sizeof(Tx) + T * CH * 4 + 2 * T * N * 4;
}

// One staged chunk: x and dt as (T, CH), B_ and C as (T, N).
template <typename Tx, int N>
struct Stage {
  Tx* x;
  float* dt;
  float* b;
  float* c;
  __device__ Stage(unsigned char* base)
      : x(reinterpret_cast<Tx*>(base)),
        dt(reinterpret_cast<float*>(base + T * CH * sizeof(Tx))),
        b(reinterpret_cast<float*>(base + T * CH * (sizeof(Tx) + 4))),
        c(reinterpret_cast<float*>(base + T * CH * (sizeof(Tx) + 4) + T * N * 4)) {}
};

// Copy steps [t0, t0 + len) of the block's channels [d0, d0 + nch) into a
// stage: 16-byte cp.async when VEC, else element-wise loads.
template <typename Tx, int N, bool VEC>
__device__ __forceinline__ void load_chunk(const Stage<Tx, N>& st, const Tx* __restrict__ x,
                                           const float* __restrict__ dt,
                                           const float* __restrict__ bm,
                                           const float* __restrict__ cm, int64_t row0, int len,
                                           int Di, int d0, int nch) {
  constexpr int NT = CH * Split<N>::TPC;
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int XV = CH * (int)sizeof(Tx) / 16, DV = CH / 4, BV = N / 4;
    const int xv = nch * (int)sizeof(Tx) / 16, dv = nch / 4;
    for (int e = tid; e < len * XV; e += NT) {
      const int r = e / XV, v = e % XV;
      if (v < xv) cp_async16(st.x + r * CH + v * (16 / sizeof(Tx)),
                             x + (row0 + r) * Di + d0 + v * (16 / sizeof(Tx)));
    }
    for (int e = tid; e < len * DV; e += NT) {
      const int r = e / DV, v = e % DV;
      if (v < dv) cp_async16(st.dt + r * CH + 4 * v, dt + (row0 + r) * Di + d0 + 4 * v);
    }
    for (int e = tid; e < len * BV; e += NT) {
      const int r = e / BV, v = e % BV;
      cp_async16(st.b + r * N + 4 * v, bm + (row0 + r) * N + 4 * v);
      cp_async16(st.c + r * N + 4 * v, cm + (row0 + r) * N + 4 * v);
    }
  } else {
    for (int e = tid; e < len * CH; e += NT) {
      const int r = e / CH, c = e % CH;
      const bool in = c < nch;
      st.x[r * CH + c] = in ? x[(row0 + r) * Di + d0 + c] : from_f32<Tx>(0.f);
      st.dt[r * CH + c] = in ? dt[(row0 + r) * Di + d0 + c] : 0.f;
    }
    for (int e = tid; e < len * N; e += NT) {
      st.b[e] = bm[row0 * N + e];
      st.c[e] = cm[row0 * N + e];
    }
  }
  cp_async_commit();
}

// U steps of the recurrence from a staged chunk, for one channel and SPT
// states. The group's operands are read before anything is written and
// its y written last, so the steps' expf, FMAs and shuffles can overlap
// (a shared-memory store between steps would order every load after it).
// y replaces x in its slot; the per-step arithmetic is the same for any U.
template <int U, typename Tx, int N>
__device__ __forceinline__ void scan_steps(const Stage<Tx, N>& st, int t, int cl, int part,
                                           int n0, const float (&an)[Split<N>::SPT],
                                           float (&h)[Split<N>::SPT], float dk) {
  constexpr int TPC = Split<N>::TPC, SPT = Split<N>::SPT;
  float xr[U], dr[U], p[U], bv[U][SPT], cv[U][SPT];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    xr[u] = to_f32(st.x[(t + u) * CH + cl]);
    dr[u] = st.dt[(t + u) * CH + cl];
    load_states<SPT>(bv[u], st.b + (t + u) * N + n0);
    load_states<SPT>(cv[u], st.c + (t + u) * N + n0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float dtx = dr[u] * xr[u];
    p[u] = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float abar = expf(dr[u] * an[j]);
      h[j] = fmaf(abar, h[j], dtx * bv[u][j]);
      p[u] = fmaf(h[j], cv[u][j], p[u]);
    }
  }
#pragma unroll
  for (int off = TPC / 2; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) p[u] += __shfl_xor_sync(0xffffffffu, p[u], off);
  if (part == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) st.x[(t + u) * CH + cl] = from_f32<Tx>(fmaf(dk, xr[u], p[u]));
  }
}

template <typename Tx, int N, bool VEC>
__global__ void __launch_bounds__(CH * Split<N>::TPC)
ssm_scan_kernel(const Tx* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, Tx* __restrict__ y,
                float* __restrict__ h_last, float* __restrict__ h_chunks, int S, int Di) {
  constexpr int TPC = Split<N>::TPC, SPT = Split<N>::SPT, NT = CH * TPC;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int SB = stage_bytes<Tx, N>();

  const int tid = threadIdx.x;
  const int cl = tid / TPC, part = tid % TPC;    // local channel, state group
  const int d0 = blockIdx.x * CH, b = blockIdx.y;
  const int nch = min(CH, Di - d0);              // live channels of the block
  const bool live = cl < nch;
  const int dd = live ? d0 + cl : Di - 1;        // spare threads shadow the last channel
  const int n0 = part * SPT;

  float an[SPT], h[SPT];
  const int64_t hidx = ((int64_t)b * Di + dd) * N + n0;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    an[j] = a[(int64_t)dd * N + n0 + j];
    h[j] = h0 != nullptr ? h0[hidx + j] : 0.f;
  }
  const float dk = dskip[dd];

  const int n_chunks = (S + T - 1) / T;
  const int64_t row_b = (int64_t)b * S;
  load_chunk<Tx, N, VEC>(Stage<Tx, N>(smem), x, dt, bm, cm, row_b, min(T, S), Di, d0, nch);
  for (int k = 0; k < n_chunks; ++k) {
    const Stage<Tx, N> st(smem + (k & 1) * SB);
    const int t0 = k * T, len = min(T, S - t0);
    if (h_chunks != nullptr && live) {   // the state entering chunk k, for the backward
      const int64_t cidx = (((int64_t)b * n_chunks + k) * Di + dd) * N + n0;
#pragma unroll
      for (int j = 0; j < SPT; ++j) h_chunks[cidx + j] = h[j];
    }
    if (k + 1 < n_chunks) {
      const Stage<Tx, N> next(smem + ((k + 1) & 1) * SB);
      load_chunk<Tx, N, VEC>(next, x, dt, bm, cm, row_b + t0 + T, min(T, S - t0 - T), Di, d0,
                             nch);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // The recurrence over the chunk, U steps at a time; y replaces x.
    int t = 0;
    for (; t + U <= len; t += U) scan_steps<U>(st, t, cl, part, n0, an, h, dk);
    for (; t < len; ++t) scan_steps<1>(st, t, cl, part, n0, an, h, dk);
    __syncthreads();

    // Coalesced copy of the chunk's y.
    const int64_t row0 = row_b + t0;
    if constexpr (VEC) {
      constexpr int XV = CH * (int)sizeof(Tx) / 16, EPV = 16 / (int)sizeof(Tx);
      const int xv = nch / EPV;
      for (int e = tid; e < len * XV; e += NT) {
        const int r = e / XV, v = e % XV;
        if (v < xv)
          *reinterpret_cast<uint4*>(y + (row0 + r) * Di + d0 + v * EPV) =
              *reinterpret_cast<const uint4*>(st.x + r * CH + v * EPV);
      }
    } else {
      for (int e = tid; e < len * CH; e += NT) {
        const int r = e / CH, c = e % CH;
        if (c < nch) y[(row0 + r) * Di + d0 + c] = st.x[r * CH + c];
      }
    }
    __syncthreads();  // the next chunk's copy reuses this stage
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) h_last[hidx + j] = h[j];
  }
}

template <typename Tx, int N, bool VEC>
cudaError_t launch_v(const void* x, const void* dt, const void* bm, const void* cm,
                     const void* a, const void* dskip, const void* h0, void* y, void* h_last,
                     void* h_chunks, int B, int S, int Di, cudaStream_t stream) {
  const int smem = 2 * stage_bytes<Tx, N>();
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_kernel<Tx, N, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Di + CH - 1) / CH), (unsigned)B);
  ssm_scan_kernel<Tx, N, VEC><<<grid, CH * Split<N>::TPC, smem, stream>>>(
      static_cast<const Tx*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dskip),
      static_cast<const float*>(h0), static_cast<Tx*>(y), static_cast<float*>(h_last),
      static_cast<float*>(h_chunks), S, Di);
  return cudaGetLastError();
}

template <typename Tx, int N>
cudaError_t launch_n(const void* x, const void* dt, const void* bm, const void* cm,
                     const void* a, const void* dskip, const void* h0, void* y, void* h_last,
                     void* h_chunks, int B, int S, int Di, cudaStream_t s) {
  if constexpr (N % 4 == 0) {
    if (Di % 8 == 0 && aligned16(x) && aligned16(dt) && aligned16(bm) && aligned16(cm) &&
        aligned16(y))
      return launch_v<Tx, N, true>(x, dt, bm, cm, a, dskip, h0, y, h_last, h_chunks, B, S, Di,
                                   s);
  }
  return launch_v<Tx, N, false>(x, dt, bm, cm, a, dskip, h0, y, h_last, h_chunks, B, S, Di, s);
}

template <typename Tx>
cudaError_t launch(const void* x, const void* dt, const void* bm, const void* cm,
                   const void* a, const void* dskip, const void* h0, void* y, void* h_last,
                   void* h_chunks, int B, int S, int Di, int N, cudaStream_t s) {
#define REPRO_SCAN_CASE(n)                                                                   \
  case n:                                                                                  \
    return launch_n<Tx, n>(x, dt, bm, cm, a, dskip, h0, y, h_last, h_chunks, B, S, Di, s);
  switch (N) {
    REPRO_SCAN_CASE(1)
    REPRO_SCAN_CASE(2)
    REPRO_SCAN_CASE(4)
    REPRO_SCAN_CASE(8)
    REPRO_SCAN_CASE(16)
    REPRO_SCAN_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SCAN_CASE
}

}  // namespace

// x and y (B, S, Di) of one type, dtype 0 float32 or 1 bf16; dt (B, S, Di),
// b and c (B, S, N), a (Di, N), d (Di,), h0 (B, Di, N) or null, h_last
// (B, Di, N), h_chunks (B, ceil(S / 64), Di, N) or null: all float32 and
// contiguous. N is 1, 2, 4, 8, 16 or 32. With h_chunks the kernel also
// writes the state entering each chunk of 64 steps (h0 or 0 first), which
// the backward (ssm_scan_bwd.cu) recomputes the chunks from; null skips
// those stores. Returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan_fwd(const void* x, const void* dt, const void* b, const void* c,
                                  const void* a, const void* d, const void* h0, void* y,
                                  void* h_last, void* h_chunks, int B, int S, int Di, int N,
                                  int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, b, c, a, d, h0, y, h_last, h_chunks, B, S, Di, N, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, b, c, a, d, h0, y, h_last, h_chunks, B, S, Di, N,
                                      s);
  return (int)cudaErrorInvalidValue;
}
