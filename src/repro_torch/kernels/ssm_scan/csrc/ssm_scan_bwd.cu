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
// Design. Every (batch row, channel) is a serial recurrence, so the card
// is filled by holding all B x Di of them at once: at hymba-1.5b's
// training shape (B 4, Di 3200, N 16) that is 12,800 channels, 97 an SM
// on 132 SMs. A block owns CH 32 channels of one batch row, TPC threads a
// channel with SPT states each (at N 16: 4 x 4, 128 threads), so the 400
// blocks are resident at once at 4 blocks (16 warps) an SM, which holds a
// block to 128 registers (__launch_bounds__) and 54 KB of shared memory.
// The block walks the sequence's 64-step chunks in reverse; each chunk's
// x, dt and dy (T x CH) and B and C (T x N) are staged in shared memory
// with 16-byte cp.async, one stage (the other blocks of the SM run while a
// block waits for its copy). The forward saved the state entering every
// chunk (h_chunks). From it a first pass steps the chunk forward to the
// start of each sub-chunk of TS 8 steps, keeping those states in shared
// memory; then, sub-chunk by sub-chunk from the last, the states and Abar
// of its steps are recomputed into registers and the adjoint is stepped
// back through them. So h is never stored per step (419 MB a layer at the
// training shape) and each (b, t, d, n) costs 15/8 expf: a longer
// sub-chunk, or keeping two of them, does not fit 128 registers. Spare
// channels and the steps past S of the last chunk are zeros in the stage,
// which makes them identity steps, so the steps run without branches.
// Sums over n (dx, ddt) take a shuffle over the channel's TPC threads;
// sums over channels (dB, dC) take a halving exchange over the warp's
// channels, after which each lane holds its own share of the step's 2N
// values, kept in shared memory for two sub-chunks. The blocks of a
// thread-block cluster (CL 4 along the channels, 128 channels) then meet,
// and each adds a slice of the pair's shares of the whole cluster through
// distributed shared memory, in (block, warp) order, into one float32
// partial per cluster (6.6 MB at the training shape). The cluster's
// barrier is split (arrive after a pair, wait before the next pair's
// sums) so the next sub-chunk's recompute runs while the cluster catches
// up. A second kernel adds the clusters' partials in order; dA and dD keep
// one partial per batch row. No float atomics: two calls give the same
// bits. dx and ddt of a sub-chunk replace its x and dt in the stage and
// each chunk is copied out coalesced. The staged copies need Di % 8 == 0,
// N % 4 == 0 and 16-byte aligned tensors (the training shapes); otherwise
// element-wise copies. Any S and Di: the grid is padded to whole clusters,
// and a block with no channel only takes its part in the cluster's sums.
//
// Bound. At hymba-1.5b's training shape (x and dy bf16) the function must
// read x, dt, dy, the chunk states, B, C, A, D and write dx, ddt, dB, dC,
// dA, dD: 99.3 MB, 0.0296 ms at 3.35 TB/s. It does about 19 float32
// operations per (b, t, d, n), 1.99 GFLOP, 0.0297 ms at 67 TFLOP/s, and
// needs one expf per (b, t, d, n), 104.9 M, 0.025 ms at 16 a clock on each
// of 132 SMs at 1.98 GHz. The kernel issues about 45 instructions per
// (b, t, d, n): the IEEE expf (8 instructions) of pass 1 and the
// recompute, the reverse step and the exchanges, so its instruction stream
// bounds it, about 0.14 ms at full issue; it takes 0.296 ms on an H100
// 80GB HBM3 at 700 W (tools/scan_bwd_time.py). chip_smoke.py derives the
// bound from its own constants and times the kernel beside it. Compile
// without --use_fast_math: the plain version uses IEEE expf, and the
// recomputed states repeat the forward's arithmetic.

#include <cooperative_groups.h>

#include <type_traits>

#include "scan_common.cuh"

namespace {

namespace cg = cooperative_groups;

using scan::T;
using scan::to_f32;
using scan::from_f32;
using scan::cp_async16;
using scan::cp_async_commit;
using scan::cp_async_wait;
using scan::load_states;
using scan::store_states;
using scan::aligned16;

constexpr int MAX_TPC = 4;    // threads a channel, at most
constexpr int TS = 8;         // steps a sub-chunk, their states held in registers
constexpr int NSUB = T / TS;  // sub-chunks per chunk
constexpr int CL = 4;         // blocks a cluster, along the channels
constexpr int WARPS = 16;     // resident warps an SM that ptxas must allow (half at N 32)
static_assert(T % TS == 0, "T must be a multiple of TS");

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// How the backward splits its work for state size N: TPC threads a
// channel, SPT states each, CH channels and NT threads a block, at least
// MINB blocks an SM.
template <int N>
struct Geo {
  static constexpr int TPC = N < MAX_TPC ? N : MAX_TPC;
  static constexpr int SPT = N / TPC;
  static constexpr int CH = 32;                 // a multiple of 8, and a warp or more
  static constexpr int NT = CH * TPC, NW = NT / 32;
  static constexpr int MINB = (N > 16 ? WARPS / 2 : WARPS) / NW;
};

// Where the channel sums of dB and dC land after reduce_scatter: each lane
// starts with V = 2 SPT values (dB then dC of its SPT states), and ends
// with R of them summed over the warp's CPW channels. Lanes whose bits in
// MASK are set hold copies of another lane's sums.
template <int N>
struct Sums {
  static constexpr int TPC = Geo<N>::TPC, SPT = Geo<N>::SPT;
  static constexpr int V = 2 * SPT, CPW = 32 / TPC;
  static constexpr int R = V > CPW ? V / CPW : 1;
  static constexpr int TOP = 16 >> ilog2(V / R);   // first xor offset that only adds
  static constexpr int MASK = TOP >= TPC ? 2 * TOP - TPC : 0;
};

template <typename Tx, int N>
__host__ __device__ constexpr int stage_bytes() {
  return T * Geo<N>::CH * (2 * (int)sizeof(Tx) + 4) + 2 * T * N * 4;
}

// The stage; the states entering sub-chunks 1 .. NSUB-1 (the first is the
// chunk's own, read from h_chunks); the warps' sums of dB and dC for two
// pairs of sub-chunks.
template <typename Tx, int N>
__host__ __device__ constexpr int smem_bytes() {
  using G = Geo<N>;
  return stage_bytes<Tx, N>() +
         4 * ((NSUB - 1) * G::NT * G::SPT + 2 * G::NW * 2 * TS * 2 * N);
}

// One staged chunk: x, dt and dy as (T, CH), B and C as (T, N). dx and
// ddt are written over x and dt once a sub-chunk no longer reads them.
template <typename Tx, int N>
struct Stage {
  static constexpr int CH = Geo<N>::CH;
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
template <typename E, int CH, int NT, bool VEC>
__device__ __forceinline__ void load_tile(E* dst, const E* __restrict__ src, int64_t row0,
                                          int len, int Di, int d0, int nch) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int EPV = 16 / (int)sizeof(E), XV = CH / EPV;
    const int xv = nch / EPV;
#pragma unroll
    for (int e0 = 0; e0 < T * XV; e0 += NT) {
      const int e = e0 + tid, r = e / XV, v = e % XV;
      if ((T * XV % NT == 0 || e < T * XV) && r < len && v < xv)
        cp_async16(dst + r * CH + v * EPV, src + (row0 + r) * Di + d0 + v * EPV);
    }
  } else {
#pragma unroll 4
    for (int e0 = 0; e0 < T * CH; e0 += NT) {
      const int e = e0 + tid, r = e / CH, c = e % CH;
      if ((T * CH % NT == 0 || e < T * CH) && r < len)
        dst[r * CH + c] = c < nch ? src[(row0 + r) * Di + d0 + c] : from_f32<E>(0.f);
    }
  }
}

// The tile's live channels back to rows [row0, row0 + len) of a (rows, Di) tensor.
template <typename E, int CH, int NT, bool VEC>
__device__ __forceinline__ void store_tile(E* __restrict__ dst, const E* src, int64_t row0,
                                           int len, int Di, int d0, int nch) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int EPV = 16 / (int)sizeof(E), XV = CH / EPV;
    const int xv = nch / EPV;
#pragma unroll
    for (int e0 = 0; e0 < T * XV; e0 += NT) {
      const int e = e0 + tid, r = e / XV, v = e % XV;
      if ((T * XV % NT == 0 || e < T * XV) && r < len && v < xv)
        *reinterpret_cast<uint4*>(dst + (row0 + r) * Di + d0 + v * EPV) =
            *reinterpret_cast<const uint4*>(src + r * CH + v * EPV);
    }
  } else {
#pragma unroll 4
    for (int e0 = 0; e0 < T * CH; e0 += NT) {
      const int e = e0 + tid, r = e / CH, c = e % CH;
      if ((T * CH % NT == 0 || e < T * CH) && r < len && c < nch)
        dst[(row0 + r) * Di + d0 + c] = src[r * CH + c];
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
  constexpr int CH = Geo<N>::CH, NT = Geo<N>::NT;
  load_tile<Tx, CH, NT, VEC>(st.x, x, row0, len, Di, d0, nch);
  load_tile<float, CH, NT, VEC>(st.dt, dt, row0, len, Di, d0, nch);
  load_tile<Tx, CH, NT, VEC>(st.dy, dy, row0, len, Di, d0, nch);
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
// [base, base + R), base = scatter_base(lane). Each sum is formed in one
// fixed order.
template <int V, int CNT, int OFF, int TPC>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane) {
  if constexpr (OFF >= TPC && OFF > 0) {
    if constexpr (CNT > 1) {
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < CNT / 2; ++i) {
        const float send = upper ? v[i] : v[i + CNT / 2];
        const float keep = upper ? v[i + CNT / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<V, CNT / 2, OFF / 2, TPC>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<V, 1, OFF / 2, TPC>(v, lane);
    }
  }
}

template <int CNT, int OFF, int TPC>
__host__ __device__ constexpr int scatter_base(int lane) {
  if constexpr (OFF >= TPC && OFF > 0 && CNT > 1)
    return ((lane & OFF) != 0 ? CNT / 2 : 0) + scatter_base<CNT / 2, OFF / 2, TPC>(lane);
  else
    return 0;
}

// The two halves of the cluster's barrier: arrive releases this thread's
// writes to shared memory, wait acquires every block's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One step of the forward recurrence, with the forward kernel's arithmetic.
template <int SPT>
__device__ __forceinline__ void step_state(float (&hn)[SPT], float (&abar)[SPT],
                                           const float (&h)[SPT], const float (&an)[SPT],
                                           const float (&bv)[SPT], float dr, float xr) {
  const float dtx = dr * xr;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    abar[j] = expf(dr * an[j]);
    hn[j] = fmaf(abar[j], h[j], dtx * bv[j]);
  }
}

// Grid (whole clusters of CL blocks along the channel blocks, B); the
// block's rank in its cluster is blockIdx.x % CL.
template <typename Tx, int N, bool VEC>
__global__ void __launch_bounds__(Geo<N>::NT, Geo<N>::MINB)
ssm_scan_bwd_kernel(const Tx* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ dskip,
                    const Tx* __restrict__ dy, const float* __restrict__ h_chunks,
                    const float* __restrict__ dh_last, Tx* __restrict__ dx,
                    float* __restrict__ ddt, float* __restrict__ part_bc,
                    float* __restrict__ part_a, float* __restrict__ part_d,
                    float* __restrict__ dh0, int S, int Di) {
  using G = Geo<N>;
  using Sm = Sums<N>;
  constexpr int TPC = G::TPC, SPT = G::SPT, CH = G::CH, NT = G::NT, NW = G::NW;
  constexpr int R = Sm::R, N2 = 2 * N;
  constexpr int SB = stage_bytes<Tx, N>();
  constexpr int KPL = TS >= TPC ? TS / TPC : 1;   // steps whose dx and ddt a lane keeps
  extern __shared__ __align__(16) unsigned char smem[];
  float* ckpt = reinterpret_cast<float*>(smem + SB);       // [NSUB-1][NT][SPT]
  float* pw = ckpt + (NSUB - 1) * NT * SPT;                // [2][NW][2][TS][2N]
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / TPC, part = tid % TPC;    // local channel, state slice
  const int rank = (int)cluster.block_rank();
  const int d0 = blockIdx.x * CH, b = blockIdx.y;
  const int nch = max(0, min(CH, Di - d0));      // live channels of the block
  const bool idle = nch == 0;                    // a block that pads the last cluster
  const bool live = cl < nch;
  const int dd = live ? d0 + cl : Di - 1;        // spare threads read the last channel's A, D
  const int n0 = part * SPT;
  const int n_chunks = (S + T - 1) / T;
  const int64_t row_b = (int64_t)b * S;
  const bool holder = (lane & Sm::MASK) == 0;    // holds its share of the warp's sums
  // where the lane's shares go in a pair's [NW][2][TS][2N] sums (first half, step 0)
  int pw_at[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int vi = scatter_base<2 * SPT, 16, TPC>(lane) + q;
    pw_at[q] = warp * 2 * TS * N2 + (vi / SPT) * N + n0 + vi % SPT;
  }
  // blocks of this cluster with channels, whose sums the cluster adds
  const int nlive = min(CL, (Di - (d0 - rank * CH) + CH - 1) / CH);
  // this cluster's partials of dB and dC: (S, 2N) rows of (clusters, B, S, 2N)
  float* part_row = part_bc + ((int64_t)(blockIdx.x / CL) * gridDim.y + b) * S * N2;

  float an[SPT], g[SPT], da[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    an[j] = a[(int64_t)dd * N + n0 + j];
    g[j] = (dh_last != nullptr && live) ? dh_last[((int64_t)b * Di + dd) * N + n0 + j] : 0.f;
    da[j] = 0.f;
  }
  const float dk = dskip[dd];
  float dsum = 0.f;                              // sum over t of dy x, for dD

  // Spare channels and the steps past S stay zero in the stage, which
  // makes them identity steps that add nothing to any sum.
  for (int e = tid; e < SB / 16; e += NT)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // The cluster's sums of dB and dC over its channels for a pair of
  // sub-chunks, from the warps' shares in buffer `par` of every block with
  // channels: the first (`plen` steps from row `prow`), and the second, if
  // `both`, the TS steps before it.
  auto cluster_sums = [&](int par, int prow, int plen, bool both) {
    for (int e = rank * NT + tid; e < 2 * TS * N2; e += CL * NT) {
      const int h = e / (TS * N2), s = e / N2 % TS, q = e % N2;
      if (h == 0 ? s < plen : both) {
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < CL; ++r) {
          if (r < nlive) {
            const float* src =
                cluster.map_shared_rank(pw, (unsigned)r) + par * (NW * 2 * TS * N2);
#pragma unroll
            for (int w = 0; w < NW; ++w) acc += src[w * 2 * TS * N2 + e];
          }
        }
        part_row[(int64_t)(prow - h * TS + s) * N2 + q] = acc;
      }
    }
  };

  const Stage<Tx, N> st(smem);
  if (!idle)
    load_chunk<Tx, N, VEC>(st, x, dt, dy, bm, cm,
                           row_b + (int64_t)(n_chunks - 1) * T, S - (n_chunks - 1) * T, Di, d0,
                           nch);
  // Sub-chunks done. The cluster meets after every second one, and sums a
  // pair: pw's buffer is the pair's parity, the half the sub-chunk's.
  int phase = 0;
  int prev_row = 0;              // rows of the first sub-chunk of the pending pair
  int prev_len = 0;
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * T, len = min(T, S - t0);
    const int nsub = (len + TS - 1) / TS;
    const int64_t cidx = (((int64_t)b * n_chunks + k) * Di + dd) * N + n0;
    if (!idle) cp_async_wait<0>();
    __syncthreads();

    // Pass 1: from the state entering the chunk, the state entering each
    // sub-chunk, with the forward's arithmetic; hs[0] ends at the last one.
    float hs[TS + 1][SPT], ab[TS][SPT];
    if (!idle) {
#pragma unroll
      for (int j = 0; j < SPT; ++j) hs[0][j] = live ? h_chunks[cidx + j] : 0.f;
      for (int i = 0; i + 1 < nsub; ++i) {
        if (i > 0) store_states<SPT>(ckpt + ((i - 1) * NT + tid) * SPT, hs[0]);
        const float* bsub = st.b + i * TS * N + n0;
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          const int r = i * TS + s;
          float bv[SPT], abar[SPT];
          load_states<SPT>(bv, bsub + s * N);
          step_state<SPT>(hs[0], abar, hs[0], an, bv, st.dt[r * CH + cl],
                          to_f32(st.x[r * CH + cl]));
        }
      }
    }

    // Pass 2, sub-chunks from the last: recompute the TS states and Abar,
    // then step the adjoint back through them.
    for (int i = nsub - 1; i >= 0; --i) {
      const int s0 = i * TS, slen = min(TS, len - s0);
      const float* bsub = st.b + s0 * N + n0;
      const float* csub = st.c + s0 * N + n0;
      if (!idle) {
        if (i + 1 < nsub) {
          if (i == 0) {
#pragma unroll
            for (int j = 0; j < SPT; ++j) hs[0][j] = live ? h_chunks[cidx + j] : 0.f;
          } else {
            load_states<SPT>(hs[0], ckpt + ((i - 1) * NT + tid) * SPT);
          }
        }
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          const int r = s0 + s;
          float bv[SPT];
          load_states<SPT>(bv, bsub + s * N);
          step_state<SPT>(hs[s + 1], ab[s], hs[s], an, bv, st.dt[r * CH + cl],
                          to_f32(st.x[r * CH + cl]));
        }
      }
      // the previous pair's sums, once every block of the cluster has its shares
      if (phase > 0 && (phase & 1) == 0) {
        cluster_wait();
        cluster_sums((phase / 2 - 1) & 1, prev_row, prev_len, true);
      }
      if (!idle) {
        float* pwb = pw + (phase / 2 & 1) * (NW * 2 * TS * N2) + (phase & 1) * (TS * N2);
        float dxk[KPL], ddk[KPL];
#pragma unroll
        for (int s = TS - 1; s >= 0; --s) {
          const int r = s0 + s;
          const float xr = to_f32(st.x[r * CH + cl]);
          const float dr = st.dt[r * CH + cl];
          const float dyr = to_f32(st.dy[r * CH + cl]);
          float bv[SPT], cv[SPT], v[2 * SPT];
          load_states<SPT>(bv, bsub + s * N);
          load_states<SPT>(cv, csub + s * N);
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
          // every lane of the channel holds the sums; lane s % TPC keeps step s's
          if (s % TPC == part) {
            dxk[s / TPC % KPL] = fmaf(dr, gb, dk * dyr);
            ddk[s / TPC % KPL] = fmaf(xr, gb, wa);
          }
          dsum = fmaf(dyr, xr, dsum);
          reduce_scatter<2 * SPT, 2 * SPT, 16, TPC>(v, lane);
          if (holder) {
#pragma unroll
            for (int q = 0; q < R; ++q) pwb[pw_at[q] + s * N2] = v[q];
          }
        }
        // dx and ddt over the sub-chunk's x and dt, which nothing reads again
#pragma unroll
        for (int m = 0; m < KPL; ++m) {
          const int s = part + m * TPC;
          if (s < TS) {
            st.x[(s0 + s) * CH + cl] = from_f32<Tx>(dxk[m]);
            st.dt[(s0 + s) * CH + cl] = ddk[m];
          }
        }
      }
      if (phase & 1) {
        cluster_arrive();
      } else {
        prev_row = t0 + s0;
        prev_len = slen;
      }
      ++phase;
    }
    __syncthreads();

    // Coalesced copy of the chunk's dx (x's slot) and ddt (dt's slot).
    if (!idle) {
      store_tile<Tx, CH, NT, VEC>(dx, st.x, row_b + t0, len, Di, d0, nch);
      store_tile<float, CH, NT, VEC>(ddt, st.dt, row_b + t0, len, Di, d0, nch);
    }
    __syncthreads();  // the next chunk's copy reuses the stage
    if (!idle && k > 0)
      load_chunk<Tx, N, VEC>(st, x, dt, dy, bm, cm, row_b + t0 - T, T, Di, d0, nch);
  }
  const bool both = (phase & 1) == 0;   // the last pair has its second sub-chunk
  if (!both) cluster_arrive();
  cluster_wait();
  cluster_sums((phase - 1) / 2 & 1, prev_row, prev_len, both);
  cluster.sync();     // no block leaves while another reads its shared memory
  if (live) {
    // the index is formed again here rather than kept live through the loops
    const int64_t hidx = ((int64_t)blockIdx.y * Di + blockIdx.x * CH + threadIdx.x / TPC) * N +
                         (threadIdx.x % TPC) * SPT;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      dh0[hidx + j] = g[j];
      part_a[hidx + j] = da[j];
    }
    if (part == 0) part_d[(int64_t)b * Di + dd] = dsum;
  }
}

// dB and dC: the clusters' partials (nparts, B, S, 2N) summed in cluster
// order; dA: the batch rows' partials (B, Di, N); dD: theirs (B, Di).
__global__ void ssm_scan_bwd_sum_kernel(const float* __restrict__ part_bc,
                                        const float* __restrict__ part_a,
                                        const float* __restrict__ part_d,
                                        float* __restrict__ db, float* __restrict__ dc,
                                        float* __restrict__ da, float* __restrict__ dd, int B,
                                        int S, int Di, int N, int nparts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nbc = (int64_t)B * S * 2 * N, na = (int64_t)Di * N;
  if (i < nbc) {
    float acc = 0.f;
    for (int k = 0; k < nparts; ++k) acc += part_bc[k * nbc + i];
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

// Channel blocks with channels, and clusters (the grid pads the last one).
template <int N>
int n_blocks(int Di) { return (Di + Geo<N>::CH - 1) / Geo<N>::CH; }
template <int N>
int n_clusters(int Di) { return (n_blocks<N>(Di) + CL - 1) / CL; }

template <int N>
int64_t work_floats(int B, int S, int Di) {
  return (int64_t)n_clusters<N>(Di) * B * S * 2 * N + (int64_t)B * Di * N + (int64_t)B * Di;
}

// The kernel for (Tx, N) and the copy route the tensors allow.
template <typename Tx, int N, bool VEC>
struct Kernel {
  static auto fn() { return ssm_scan_bwd_kernel<Tx, N, VEC>; }
  static cudaError_t prepare() {
    cudaError_t err = cudaFuncSetAttribute(fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes<Tx, N>());
    return err;
  }
  static cudaLaunchConfig_t config(int B, int Di, cudaLaunchAttribute* attr,
                                   cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_clusters<N>(Di) * CL), (unsigned)B);
    cfg.blockDim = dim3(Geo<N>::NT);
    cfg.dynamicSmemBytes = smem_bytes<Tx, N>();
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }
};

template <typename Tx, int N, bool VEC>
cudaError_t launch_v(const Args& p, cudaStream_t stream) {
  using K = Kernel<Tx, N, VEC>;
  cudaError_t err = K::prepare();
  if (err != cudaSuccess) return err;
  const int ncl = n_clusters<N>(p.Di);
  float* part_bc = static_cast<float*>(p.work);
  float* part_a = part_bc + (int64_t)ncl * p.B * p.S * 2 * N;
  float* part_d = part_a + (int64_t)p.B * p.Di * N;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = K::config(p.B, p.Di, attr, stream);
  err = cudaLaunchKernelEx(
      &cfg, K::fn(), static_cast<const Tx*>(p.x), static_cast<const float*>(p.dt),
      static_cast<const float*>(p.b), static_cast<const float*>(p.c),
      static_cast<const float*>(p.a), static_cast<const float*>(p.d),
      static_cast<const Tx*>(p.dy), static_cast<const float*>(p.h_chunks),
      static_cast<const float*>(p.dh_last), static_cast<Tx*>(p.dx), static_cast<float*>(p.ddt),
      part_bc, part_a, part_d, static_cast<float*>(p.dh0), p.S, p.Di);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)p.B * p.S * 2 * N + (int64_t)p.Di * N + p.Di;
  ssm_scan_bwd_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      part_bc, part_a, part_d, static_cast<float*>(p.db), static_cast<float*>(p.dc),
      static_cast<float*>(p.da), static_cast<float*>(p.dd), p.B, p.S, p.Di, N, ncl);
  return cudaGetLastError();
}

bool vec_route(const Args& p) {
  return p.N % 4 == 0 && p.Di % 8 == 0 && aligned16(p.x) && aligned16(p.dt) &&
         aligned16(p.dy) && aligned16(p.b) && aligned16(p.c) && aligned16(p.dx) &&
         aligned16(p.ddt);
}

// f(std::integral_constant<int, N>) for the state sizes the kernel takes,
// `other` for any other N.
template <typename R, typename F>
R with_n(int N, R other, F&& f) {
  switch (N) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return other;
  }
}

template <typename Tx>
cudaError_t launch(const Args& p, cudaStream_t s) {
  const bool vec = vec_route(p);
  return with_n(p.N, cudaErrorInvalidValue, [&](auto n) -> cudaError_t {
    constexpr int N = decltype(n)::value;
    if constexpr (N % 4 == 0) {
      if (vec) return launch_v<Tx, N, true>(p, s);
    }
    return launch_v<Tx, N, false>(p, s);
  });
}

// out: blocks, threads a block, blocks a cluster, resident blocks an SM,
// clusters resident at once, SMs, registers a thread, spill bytes a thread
// (local memory), dynamic shared memory bytes a block.
template <typename Tx, int N, bool VEC>
cudaError_t geometry(int B, int Di, int* out) {
  using K = Kernel<Tx, N, VEC>;
  cudaError_t err = K::prepare();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0, clusters = 0;
  cudaFuncAttributes fa;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, (const void*)K::fn(), Geo<N>::NT, smem_bytes<Tx, N>())) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&fa, (const void*)K::fn())) != cudaSuccess)
    return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = K::config(B, Di, attr, nullptr);
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)K::fn(), &cfg)) !=
      cudaSuccess)
    return err;
  out[0] = n_clusters<N>(Di) * CL * B;
  out[1] = Geo<N>::NT;
  out[2] = CL;
  out[3] = per_sm;
  out[4] = clusters;
  out[5] = sms;
  out[6] = fa.numRegs;
  out[7] = (int)fa.localSizeBytes;
  out[8] = smem_bytes<Tx, N>();
  return cudaSuccess;
}

}  // namespace

// Floats of the scratch `work` that repro_ssm_scan_bwd needs: the partial
// sums of dB and dC per cluster, of dA and dD per batch row; -1 for an N
// the kernel does not take.
extern "C" long long repro_ssm_scan_bwd_work_floats(int B, int S, int Di, int N) {
  return with_n(N, -1LL, [&](auto n) -> long long {
    return (long long)work_floats<decltype(n)::value>(B, S, Di);
  });
}

// The launch geometry of repro_ssm_scan_bwd for these sizes, dtype 0
// float32 or 1 bf16 and 16-byte aligned tensors, into out[9] as
// `geometry` above lists it. Returns the CUDA error.
extern "C" int repro_ssm_scan_bwd_geometry(int B, int S, int Di, int N, int dtype, int* out) {
  if (B <= 0 || S <= 0 || Di <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && Di % 8 == 0;
  return (int)with_n(N, cudaErrorInvalidValue, [&](auto n) -> cudaError_t {
    constexpr int N_ = decltype(n)::value;
    if constexpr (N_ % 4 == 0) {
      if (vec)
        return dtype == 0 ? geometry<float, N_, true>(B, Di, out)
                          : geometry<__nv_bfloat16, N_, true>(B, Di, out);
    }
    return dtype == 0 ? geometry<float, N_, false>(B, Di, out)
                      : geometry<__nv_bfloat16, N_, false>(B, Di, out);
  });
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
