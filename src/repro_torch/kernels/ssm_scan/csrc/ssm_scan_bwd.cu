// Backward of the mamba-1 selective scan for Hopper (sm_90a).
//
// No TPU kernel has this role: the JAX package differentiates its scan
// (src/repro/models/ssm.py `selective_scan`: `_discretize` and
// `_chunk_scan` under `jax.checkpoint` per chunk) through XLA. The port's
// forward is the CUDA kernel of ssm_scan.cu, which autograd cannot see
// through, so this is its gradient. With Abar_t = exp(dt_t A), the reverse
// recurrence on the adjoint state g (B, Di, N), from g = dh_last (or 0),
// for t from S-1 down to 0 is
//   g += C_t dy_t
//   dC_t[n] = sum_d dy_t[d] h_t[d, n]         dB_t[n] = sum_d g dt_t x_t
//   dx_t = dt_t sum_n g B_t + D dy_t          ddt_t = sum_n g (A Abar_t h_{t-1} + x_t B_t)
//   dA += g dt_t Abar_t h_{t-1}               g <- Abar_t g
// and dD = sum_{b,t} dy x, dh0 = g. x, dy and dx have x's type (float32
// or bf16); everything else is float32. It matches the plain version
// ref.selective_scan_bwd_ref.
//
// Design. A block owns CH channels of one batch row, one thread per
// (channel, state slice) as in the forward, and walks the sequence's
// chunks of T steps in reverse; each chunk's x, dt, dy (T x CH) and B, C
// (T x N) are staged in shared memory with 16-byte cp.async, double
// buffered so chunk k-1 loads while chunk k runs. The forward saved the
// state entering every chunk (h_chunks). From it a first pass steps the
// chunk forward and keeps the state at each sub-chunk of TS steps in
// shared memory; then, sub-chunk by sub-chunk from the last, the states
// and Abar of its TS steps are recomputed into registers and the adjoint
// is stepped back through them. So h is never stored per step (that would
// be 419 MB a layer at hymba-1.5b's training shape) and each (b, t, d, n)
// costs two expf. The sums over n (dx, ddt) take a shuffle over the
// channel's TPC threads. The sums over channels (dB, dC) take a halving
// exchange over the warp's channels, after which each lane holds its own
// share of the 2N values of a step, then a sum over the block's warps in
// shared memory, in a fixed order, into one float32 partial per channel
// block; dA and dD keep one partial per batch row. A second kernel adds
// the partials. There are no float atomics, so two calls give the same
// bits. dx and ddt of a sub-chunk replace its x and dt in shared memory
// and each chunk is copied out coalesced.
// The staged copies need Di % 8 == 0, N % 4 == 0 and 16-byte aligned
// tensors (the training shapes); otherwise element-wise copies. Any S and
// Di: the spare channels of the last block are computed on zeros and never
// stored, the spare steps of the last chunk are skipped.
//
// Bound. At hymba-1.5b's training shape (B 4, S 512, Di 3200, N 16, x and
// dy bf16) the function must read x, dt, dy, the chunk states, B, C, A, D
// and write dx, ddt, dB, dC, dA, dD: 99.6 MB, 0.030 ms at 3.35 TB/s. It
// does about 19 float32 operations per (b, t, d, n), 2.0 GFLOP, 0.030 ms
// at 67 TFLOP/s, and needs one expf per (b, t, d, n), 104.9 M, 0.025 ms at
// 16 a clock on each of 132 SMs at 1.98 GHz; this kernel computes two.
// chip_smoke.py derives the bound from its own constants and times the
// kernel beside it. Compile without --use_fast_math: the plain version
// uses IEEE expf, and the recomputed states repeat the forward's
// arithmetic.

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
using scan::store_states;
using scan::aligned16;

constexpr int CH = 64;        // channels per block
constexpr int TS = 8;         // steps per sub-chunk, their states held in registers
constexpr int NSUB = T / TS;  // sub-chunks per chunk
static_assert(CH % 8 == 0 && T % TS == 0, "CH must be a multiple of 8, T of TS");

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

template <int N>
__host__ __device__ constexpr int threads() { return CH * Split<N>::TPC; }

// Where the channel sums of dB and dC land after reduce_scatter: each lane
// starts with V = 2 SPT values (dB then dC of its SPT states), and ends
// with R of them summed over the warp's CPW channels. Lanes whose bits in
// MASK are set hold copies of another lane's sums.
template <int N>
struct Sums {
  static constexpr int TPC = Split<N>::TPC, SPT = Split<N>::SPT;
  static constexpr int V = 2 * SPT, CPW = 32 / TPC;
  static constexpr int R = V > CPW ? V / CPW : 1;
  static constexpr int TOP = 16 >> ilog2(V / R);   // first xor offset that only adds
  static constexpr int MASK = TOP >= TPC ? 2 * TOP - TPC : 0;
};

template <typename Tx, int N>
__host__ __device__ constexpr int stage_bytes() {
  return T * CH * (2 * (int)sizeof(Tx) + 4) + 2 * T * N * 4;
}

template <int N>
__host__ __device__ constexpr int smem_bytes(int stage) {
  return 2 * stage + 4 * (NSUB * threads<N>() * Split<N>::SPT +
                          2 * (threads<N>() / 32) * TS * 2 * N);
}

// One staged chunk: x, dt and dy as (T, CH), B and C as (T, N). dx and
// ddt are written over x and dt once a sub-chunk no longer reads them.
template <typename Tx, int N>
struct Stage {
  Tx* x;
  float* dt;
  Tx* dy;
  float* b;
  float* c;
  __device__ explicit Stage(unsigned char* base)
      : x(reinterpret_cast<Tx*>(base)),
        dt(reinterpret_cast<float*>(base + T * CH * sizeof(Tx))),
        dy(reinterpret_cast<Tx*>(base + T * CH * (sizeof(Tx) + 4))),
        b(reinterpret_cast<float*>(base + T * CH * (2 * sizeof(Tx) + 4))),
        c(b + T * N) {}
};

// Rows [row0, row0 + len) and channels [d0, d0 + nch) of a (rows, Di)
// tensor into a (T, CH) tile: 16-byte cp.async when VEC (committed by the
// caller), else element-wise with zeros in the spare channels.
template <typename E, int NT, bool VEC>
__device__ __forceinline__ void load_tile(E* dst, const E* __restrict__ src, int64_t row0,
                                          int len, int Di, int d0, int nch) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int EPV = 16 / (int)sizeof(E), XV = CH / EPV;
    const int xv = nch / EPV;
    for (int e = tid; e < len * XV; e += NT) {
      const int r = e / XV, v = e % XV;
      if (v < xv) cp_async16(dst + r * CH + v * EPV, src + (row0 + r) * Di + d0 + v * EPV);
    }
  } else {
    for (int e = tid; e < len * CH; e += NT) {
      const int r = e / CH, c = e % CH;
      dst[r * CH + c] = c < nch ? src[(row0 + r) * Di + d0 + c] : from_f32<E>(0.f);
    }
  }
}

// The tile's live channels back to rows [row0, row0 + len) of a (rows, Di) tensor.
template <typename E, int NT, bool VEC>
__device__ __forceinline__ void store_tile(E* __restrict__ dst, const E* src, int64_t row0,
                                           int len, int Di, int d0, int nch) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int EPV = 16 / (int)sizeof(E), XV = CH / EPV;
    const int xv = nch / EPV;
    for (int e = tid; e < len * XV; e += NT) {
      const int r = e / XV, v = e % XV;
      if (v < xv)
        *reinterpret_cast<uint4*>(dst + (row0 + r) * Di + d0 + v * EPV) =
            *reinterpret_cast<const uint4*>(src + r * CH + v * EPV);
    }
  } else {
    for (int e = tid; e < len * CH; e += NT) {
      const int r = e / CH, c = e % CH;
      if (c < nch) dst[(row0 + r) * Di + d0 + c] = src[r * CH + c];
    }
  }
}

template <typename Tx, int N, bool VEC>
__device__ __forceinline__ void load_chunk(const Stage<Tx, N>& st, const Tx* __restrict__ x,
                                           const float* __restrict__ dt,
                                           const Tx* __restrict__ dy,
                                           const float* __restrict__ bm,
                                           const float* __restrict__ cm, int64_t row0, int len,
                                           int Di, int d0, int nch) {
  constexpr int NT = threads<N>();
  load_tile<Tx, NT, VEC>(st.x, x, row0, len, Di, d0, nch);
  load_tile<float, NT, VEC>(st.dt, dt, row0, len, Di, d0, nch);
  load_tile<Tx, NT, VEC>(st.dy, dy, row0, len, Di, d0, nch);
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    for (int e = tid; e < len * N / 4; e += NT) {
      cp_async16(st.b + 4 * e, bm + row0 * N + 4 * e);
      cp_async16(st.c + 4 * e, cm + row0 * N + 4 * e);
    }
  } else {
    for (int e = tid; e < len * N; e += NT) {
      st.b[e] = bm[row0 * N + e];
      st.c[e] = cm[row0 * N + e];
    }
  }
  cp_async_commit();
}

// Sums of V values over the lanes of a warp that hold the same state slice
// of different channels (lane % TPC equal), by halving exchanges at xor
// offsets 16, 8, ..., TPC: at each level a lane keeps half of the values it
// still holds and sends the other half, so the warp's 2N sums of a step
// take at most 7 shuffles a lane. Then v[0, R) hold the sums of values
// [base, base + R). Each sum is formed in one fixed order.
template <int V, int CNT, int OFF, int TPC>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane, int& base) {
  if constexpr (OFF >= TPC && OFF > 0) {
    if constexpr (CNT > 1) {
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < CNT / 2; ++i) {
        const float send = upper ? v[i] : v[i + CNT / 2];
        const float keep = upper ? v[i + CNT / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (upper) base += CNT / 2;
      reduce_scatter<V, CNT / 2, OFF / 2, TPC>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<V, 1, OFF / 2, TPC>(v, lane, base);
    }
  }
}

template <typename Tx, int N, bool VEC>
__global__ void __launch_bounds__(CH * Split<N>::TPC)
ssm_scan_bwd_kernel(const Tx* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ dskip,
                    const Tx* __restrict__ dy, const float* __restrict__ h_chunks,
                    const float* __restrict__ dh_last, Tx* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ part_bc,
                    float* __restrict__ part_a, float* __restrict__ part_d,
                    float* __restrict__ dh0, int S, int Di) {
  using Sm = Sums<N>;
  constexpr int TPC = Sm::TPC, SPT = Sm::SPT, R = Sm::R;
  constexpr int NT = threads<N>(), NW = NT / 32, N2 = 2 * N;
  constexpr int SB = stage_bytes<Tx, N>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* ckpt = reinterpret_cast<float*>(smem + 2 * SB);   // [NSUB][NT][SPT] sub-chunk starts
  float* pw = ckpt + NSUB * NT * SPT;                       // [2][NW][TS][2N] warps' sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / TPC, part = tid % TPC;    // local channel, state slice
  const int d0 = blockIdx.x * CH, b = blockIdx.y;
  const int nch = min(CH, Di - d0);              // live channels of the block
  const bool live = cl < nch;
  const int dd = live ? d0 + cl : Di - 1;        // spare threads read the last channel's A, D
  const int n0 = part * SPT;
  const int n_chunks = (S + T - 1) / T;
  const int64_t row_b = (int64_t)b * S;
  const int64_t hidx = ((int64_t)b * Di + dd) * N + n0;
  const bool holder = (lane & Sm::MASK) == 0;    // holds its share of the warp's sums

  float an[SPT], g[SPT], da[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    an[j] = a[(int64_t)dd * N + n0 + j];
    g[j] = (dh_last != nullptr && live) ? dh_last[hidx + j] : 0.f;
    da[j] = 0.f;
  }
  const float dk = dskip[dd];
  float dsum = 0.f;                              // sum over t of dy x, for dD
  int sub_count = 0;                             // sub-chunks done: pw's parity

  load_chunk<Tx, N, VEC>(Stage<Tx, N>(smem + ((n_chunks - 1) & 1) * SB), x, dt, dy, bm, cm,
                         row_b + (int64_t)(n_chunks - 1) * T, S - (n_chunks - 1) * T, Di, d0,
                         nch);
  for (int k = n_chunks - 1; k >= 0; --k) {
    const Stage<Tx, N> st(smem + (k & 1) * SB);
    const int t0 = k * T, len = min(T, S - t0);
    if (k > 0) {
      load_chunk<Tx, N, VEC>(Stage<Tx, N>(smem + ((k - 1) & 1) * SB), x, dt, dy, bm, cm,
                             row_b + t0 - T, T, Di, d0, nch);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Pass 1: from the state entering the chunk, the state entering each
    // sub-chunk, with the forward's arithmetic.
    const int nsub = (len + TS - 1) / TS;
    {
      float h[SPT];
      const int64_t cidx = (((int64_t)b * n_chunks + k) * Di + dd) * N + n0;
#pragma unroll
      for (int j = 0; j < SPT; ++j) h[j] = h_chunks[cidx + j];
      for (int i = 0; i < nsub; ++i) {
        store_states<SPT>(ckpt + (i * NT + tid) * SPT, h);
        if (i + 1 == nsub) break;
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          const int r = i * TS + s;
          const float xr = live ? to_f32(st.x[r * CH + cl]) : 0.f;
          const float dr = live ? st.dt[r * CH + cl] : 0.f;
          float bv[SPT];
          load_states<SPT>(bv, st.b + r * N + n0);
          const float dtx = dr * xr;
#pragma unroll
          for (int j = 0; j < SPT; ++j) h[j] = fmaf(expf(dr * an[j]), h[j], dtx * bv[j]);
        }
      }
    }

    // Pass 2, sub-chunks from the last: recompute the TS states and Abar,
    // then step the adjoint back through them.
    for (int i = nsub - 1; i >= 0; --i) {
      const int s0 = i * TS, slen = min(TS, len - s0);
      float hs[TS + 1][SPT], ab[TS][SPT];
      load_states<SPT>(hs[0], ckpt + (i * NT + tid) * SPT);
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        if (s < slen) {
          const int r = s0 + s;
          const float xr = live ? to_f32(st.x[r * CH + cl]) : 0.f;
          const float dr = live ? st.dt[r * CH + cl] : 0.f;
          float bv[SPT];
          load_states<SPT>(bv, st.b + r * N + n0);
          const float dtx = dr * xr;
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            ab[s][j] = expf(dr * an[j]);
            hs[s + 1][j] = fmaf(ab[s][j], hs[s][j], dtx * bv[j]);
          }
        }
      }
      float dxv[TS], ddtv[TS], sums[TS][R];
      int base = 0;
#pragma unroll
      for (int s = TS - 1; s >= 0; --s) {
        if (s < slen) {
          const int r = s0 + s;
          const float xr = live ? to_f32(st.x[r * CH + cl]) : 0.f;
          const float dr = live ? st.dt[r * CH + cl] : 0.f;
          const float dyr = live ? to_f32(st.dy[r * CH + cl]) : 0.f;
          float bv[SPT], cv[SPT], v[2 * SPT];
          load_states<SPT>(bv, st.b + r * N + n0);
          load_states<SPT>(cv, st.c + r * N + n0);
          const float dtx = dr * xr;
          float gb = 0.f, wa = 0.f;
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            g[j] = fmaf(cv[j], dyr, g[j]);
            v[j] = g[j] * dtx;                    // dB_t[n], this channel's term
            v[SPT + j] = dyr * hs[s + 1][j];      // dC_t[n], this channel's term
            gb = fmaf(g[j], bv[j], gb);
            const float w = g[j] * ab[s][j] * hs[s][j];
            wa = fmaf(an[j], w, wa);
            da[j] = fmaf(dr, w, da[j]);
            g[j] *= ab[s][j];
          }
#pragma unroll
          for (int off = TPC / 2; off > 0; off >>= 1) {
            gb += __shfl_xor_sync(0xffffffffu, gb, off);
            wa += __shfl_xor_sync(0xffffffffu, wa, off);
          }
          dxv[s] = fmaf(dr, gb, dk * dyr);
          ddtv[s] = fmaf(xr, gb, wa);
          dsum = fmaf(dyr, xr, dsum);
          base = 0;
          reduce_scatter<2 * SPT, 2 * SPT, 16, TPC>(v, lane, base);
#pragma unroll
          for (int q = 0; q < R; ++q) sums[s][q] = v[q];
        }
      }
      // dx and ddt over the sub-chunk's x and dt, which nothing reads again
      if (live && part == 0) {
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          if (s < slen) {
            st.x[(s0 + s) * CH + cl] = from_f32<Tx>(dxv[s]);
            st.dt[(s0 + s) * CH + cl] = ddtv[s];
          }
        }
      }
      // the warps' sums of dB and dC, then their sum in warp order
      float* pwb = pw + (sub_count & 1) * (NW * TS * N2);
      if (holder) {
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          if (s < slen) {
#pragma unroll
            for (int q = 0; q < R; ++q) {
              const int vi = base + q;
              pwb[(warp * TS + s) * N2 + (vi / SPT) * N + n0 + vi % SPT] = sums[s][q];
            }
          }
        }
      }
      __syncthreads();
      const int64_t row0 = ((int64_t)blockIdx.x * gridDim.y + b) * S + t0 + s0;
      for (int e = tid; e < slen * N2; e += NT) {
        const int s = e / N2, q = e % N2;
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) acc += pwb[(w * TS + s) * N2 + q];
        part_bc[(row0 + s) * N2 + q] = acc;
      }
      ++sub_count;
    }
    __syncthreads();

    // Coalesced copy of the chunk's dx (x's slot) and ddt (dt's slot).
    store_tile<Tx, NT, VEC>(dx, st.x, row_b + t0, len, Di, d0, nch);
    store_tile<float, NT, VEC>(ddt, st.dt, row_b + t0, len, Di, d0, nch);
    __syncthreads();  // the next chunk's copy reuses this stage
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      dh0[hidx + j] = g[j];
      part_a[hidx + j] = da[j];
    }
    if (part == 0) part_d[(int64_t)b * Di + dd] = dsum;
  }
}

// dB and dC: the channel blocks' partials (nblk, B, S, 2N) summed in block
// order; dA: the batch rows' partials (B, Di, N); dD: theirs (B, Di).
__global__ void ssm_scan_bwd_sum_kernel(const float* __restrict__ part_bc,
                                        const float* __restrict__ part_a,
                                        const float* __restrict__ part_d,
                                        float* __restrict__ db, float* __restrict__ dc,
                                        float* __restrict__ da, float* __restrict__ dd, int B,
                                        int S, int Di, int N, int nblk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nbc = (int64_t)B * S * 2 * N, na = (int64_t)Di * N;
  if (i < nbc) {
    float acc = 0.f;
    for (int k = 0; k < nblk; ++k) acc += part_bc[k * nbc + i];
    const int64_t row = i / (2 * N);
    const int q = (int)(i % (2 * N));
    (q < N ? db : dc)[row * N + q % N] = acc;
  } else if (i < nbc + na) {
    const int64_t j = i - nbc;
    float acc = 0.f;
    for (int bb = 0; bb < B; ++bb) acc += part_a[bb * na + j];
    da[j] = acc;
  } else if (i < nbc + na + Di) {
    const int64_t j = i - nbc - na;
    float acc = 0.f;
    for (int bb = 0; bb < B; ++bb) acc += part_d[(int64_t)bb * Di + j];
    dd[j] = acc;
  }
}

struct Args {
  const void *x, *dt, *b, *c, *a, *d, *dy, *h_chunks, *dh_last;
  void *dx, *ddt, *db, *dc, *da, *dd, *dh0, *work;
  int B, S, Di, N;
};

int n_blocks(int Di) { return (Di + CH - 1) / CH; }

int64_t work_floats(int B, int S, int Di, int N) {
  return (int64_t)n_blocks(Di) * B * S * 2 * N + (int64_t)B * Di * N + (int64_t)B * Di;
}

template <typename Tx, int N, bool VEC>
cudaError_t launch_v(const Args& p, cudaStream_t stream) {
  const int smem = smem_bytes<N>(stage_bytes<Tx, N>());
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<Tx, N, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nblk = n_blocks(p.Di);
  float* part_bc = static_cast<float*>(p.work);
  float* part_a = part_bc + (int64_t)nblk * p.B * p.S * 2 * N;
  float* part_d = part_a + (int64_t)p.B * p.Di * N;
  ssm_scan_bwd_kernel<Tx, N, VEC><<<dim3((unsigned)nblk, (unsigned)p.B), threads<N>(), smem,
                                    stream>>>(
      static_cast<const Tx*>(p.x), static_cast<const float*>(p.dt),
      static_cast<const float*>(p.b), static_cast<const float*>(p.c),
      static_cast<const float*>(p.a), static_cast<const float*>(p.d),
      static_cast<const Tx*>(p.dy), static_cast<const float*>(p.h_chunks),
      static_cast<const float*>(p.dh_last), static_cast<Tx*>(p.dx), static_cast<float*>(p.ddt),
      part_bc, part_a, part_d, static_cast<float*>(p.dh0), p.S, p.Di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)p.B * p.S * 2 * N + (int64_t)p.Di * N + p.Di;
  ssm_scan_bwd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part_bc, part_a, part_d, static_cast<float*>(p.db), static_cast<float*>(p.dc),
      static_cast<float*>(p.da), static_cast<float*>(p.dd), p.B, p.S, p.Di, N, nblk);
  return cudaGetLastError();
}

template <typename Tx, int N>
cudaError_t launch_n(const Args& p, cudaStream_t s) {
  if constexpr (N % 4 == 0) {
    if (p.Di % 8 == 0 && aligned16(p.x) && aligned16(p.dt) && aligned16(p.dy) &&
        aligned16(p.b) && aligned16(p.c) && aligned16(p.dx) && aligned16(p.ddt))
      return launch_v<Tx, N, true>(p, s);
  }
  return launch_v<Tx, N, false>(p, s);
}

template <typename Tx>
cudaError_t launch(const Args& p, cudaStream_t s) {
  switch (p.N) {
    case 1: return launch_n<Tx, 1>(p, s);
    case 2: return launch_n<Tx, 2>(p, s);
    case 4: return launch_n<Tx, 4>(p, s);
    case 8: return launch_n<Tx, 8>(p, s);
    case 16: return launch_n<Tx, 16>(p, s);
    case 32: return launch_n<Tx, 32>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of the scratch `work` that repro_ssm_scan_bwd needs: the partial
// sums of dB and dC per channel block, of dA and dD per batch row.
extern "C" long long repro_ssm_scan_bwd_work_floats(int B, int S, int Di, int N) {
  return (long long)work_floats(B, S, Di, N);
}

// x, dy and dx (B, S, Di) of one type, dtype 0 float32 or 1 bf16; dt and
// ddt (B, S, Di), b, c, db and dc (B, S, N), a and da (Di, N), d and dd
// (Di,), h_chunks (B, ceil(S / 64), Di, N) as repro_ssm_scan_fwd writes it,
// dh_last (B, Di, N) or null, dh0 (B, Di, N), work as sized above: all
// float32 and contiguous. N is 1, 2, 4, 8, 16 or 32. Two kernels on
// `stream`; returns cudaGetLastError() after each launch.
extern "C" int repro_ssm_scan_bwd(const void* x, const void* dt, const void* b, const void* c,
                                  const void* a, const void* d, const void* dy,
                                  const void* h_chunks, const void* dh_last, void* dx,
                                  void* ddt, void* db, void* dc, void* da, void* dd, void* dh0,
                                  void* work, int B, int S, int Di, int N, int dtype,
                                  void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || Di <= 0 || h_chunks == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args p{x, dt, b, c, a, d, dy, h_chunks, dh_last, dx, ddt, db, dc, da, dd, dh0, work,
               B, S, Di, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
