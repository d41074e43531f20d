// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma, TMA), and float32 or bf16 at small head dims on the CUDA cores.
//
// The TPU package has no backward kernel: its trainer differentiates the plain
// attention (src/repro/models/model.py, attention_xla) through XLA, and the
// Pallas forward (src/repro/kernels/flash_attention/kernel.py, flash_attention)
// serves prefill only. In this port the model's attention on the card is the
// forward kernel of flash_attention.cu, which autograd cannot see through, so
// training needs this kernel behind a torch.autograd.Function (../ops.py,
// FlashAttentionFn). It computes what jax.vjp of the JAX attention_ref gives:
// for causal or sliding-window GQA attention with Sq == Sk, scores
// s = q.k / sqrt(hd) masked with -1e30, P = softmax(s) per query row,
//
//   dV = P^T dO            (summed over the G = H / KV query heads of a group)
//   dS = P * (dO V^T - D),  D = rowsum(dO * O)
//   dQ = dS K / sqrt(hd),   dK = dS^T Q / sqrt(hd)
//
// with P = exp(s - lse) recomputed from the per-row log-sum-exp that the
// forward kernel stored in its epilogue (natural log, float32). Every route
// skips the tiles the mask cannot reach (the forward kernels' block rule) and
// stores dq, dk, dv in the input type. Three launches a call on either
// route; the first is the same kernel on both:
//
//   fa_bwd_dsum: D = rowsum(dO * O) per query row, float32, each thread one
//   16-byte load of O and of dO, a row's threads summed by shuffles; a
//   memory-bound pass over O and dO (12.6 MB at qwen2-1.5b's shape).
//
// The tensor-core route (repro_flash_attention_bwd_sm90; dQ runs on a second
// stream beside dK/dV: the dK/dV clusters leave SMs that no cluster of G
// fits on, and dQ's blocks fill them; on an H100 17 clusters of 6 fit at hd
// 128, 102 of the 132 SMs, as repro_flash_attention_bwd_dkdv_clusters
// reports): bf16 at head_dim 64 or 128, G <= 8. 160 threads a block: warps
// 0-3 one consumer warpgroup, warp 4 the producer, whose lane 0 issues TMA
// copies of 64 x 64 boxes with a 128-byte swizzle into rings of two stages
// with full and empty mbarriers, the scheme of fa_fwd_sm90 (the helpers are
// shared through sm90.cuh).
//
//   fa_bwd_dkdv_sm90, one block per (query head, batch, 64-key tile), key
//   tile 0 (the heaviest under a causal mask) launched first. The block loads
//   its K and V tile once and walks the query tiles of its head that reach
//   it, the producer keeping Q and dO tiles, with their rows' lse (times
//   log2 e) and D, two tiles ahead. Per query tile the consumer computes
//   S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major
//   from shared memory), P^T = 2^(S^T scale log2 e - lse log2 e) and
//   dS^T = P^T (dP^T - D) on the accumulator fragments (masked only on tiles
//   that cross the diagonal, the window edge or S), then dV += P^T dO and
//   dK += dS^T Q (wgmma m64n{hd}k16, A the fragments rounded to bf16 in
//   registers, B the same Q and dO tiles read MN-major, as the forward reads
//   V): four products of hd per attended pair. The G blocks of one key tile
//   and KV head form one thread-block cluster; after the walk each block
//   puts its float32 dK and dV into its own shared memory, and block r of
//   the cluster sums rows [r * 128 / G, ...) of the G copies through
//   distributed shared memory in the fixed order of the heads (the G loads
//   of an element in flight together), scales dK and stores both. No
//   atomics: the result does not depend on the order in which blocks run,
//   and two calls give the same bits. 255 registers at hd 128 (one block an
//   SM), 168 at hd 64 (two).
//   fa_bwd_dq_sm90, one block per (64-row query tile, head, batch), heaviest
//   first: Q and dO loaded once, K and V tiles through the ring; S = Q K^T
//   and dP = dO V^T as above, P and dS on the fragments (two rows' lse and D
//   a thread), dQ += dS K with K read MN-major: three products of hd per
//   pair, no float32 scratch in device memory.
//
// The CUDA-core route (repro_flash_attention_bwd, all three launches on one
// stream): float32 at every head_dim,
// bf16 at 16 or 32 (and bf16 groups of more than 8 heads). Each kernel keeps
// its tiles in shared memory as float32, rows padded by one float so that the
// strided reads hit distinct banks, and every product and sum is IEEE float32
// (no TF32, no tensor cores, expf), which the float32 bound of 1e-5 needs:
//
//   fa_bwd_dkdv, grid (key tiles, KV, B): a block holds one 64-key tile of
//      K and V and walks the query tiles of all G heads of its group that the
//      mask reaches; per tile it recomputes S = Q K^T and dP = dO V^T (each of
//      256 threads a 4 x 4 block), P = exp(S - lse) and dS = P (dP - D) into
//      shared memory, then adds P^T dO and dS^T Q into dV and dK, held in
//      registers (4 keys x hd / 16 columns a thread). A block owns its dK and
//      dV, so there are no atomics here either.
//   fa_bwd_dq, grid (query tiles, H, B): a block holds one 64-row tile of Q
//      and dO and walks the reachable key tiles: S, dP and dS as in dK/dV,
//      then dQ += dS K in registers.
//
// Bound. At the qwen2-1.5b training shape (B 4, S 512, H 12, KV 2, hd 128,
// causal, bf16) the backward needs five products of hd per attended pair
// (the recomputed Q K^T, dV, dP, dK, dQ): 6.30 M pairs x 5 x 2 x 128 = 8.07
// GFLOP, 0.0082 ms at the 989 TFLOP/s bf16 tensor rate, and it moves q, o,
// dO, k, v in and dq, dk, dv out once, 29.4 MB, 0.0088 ms at 3.35 TB/s: the
// bytes bound it, the operations nearly so. The tensor-core route does seven
// products of hd per pair (Q K^T and dO V^T in both kernels) at the tensor
// rate. On an H100 (700 W) it takes about 0.075 ms there and at hymba-1.5b's
// shape (tools/flash_bwd_time.py, device times), against 0.068-0.070 and
// 0.076 ms for PyTorch's SDPA backward: dK/dV about 0.063 ms of it, latency
// bound, each block's tiles following one another with the products, the
// exponentials and the waits in one warpgroup (no room for a second at hd
// 128: two consumer warpgroups spilled at ptxas's 168-register cap, and
// overlapping the exponentials with the products in one warpgroup gained
// nothing). The CUDA-core route takes 1.05-1.45 ms on the same bf16 inputs.

#include <cooperative_groups.h>

#include <mutex>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block
constexpr int LDS = BK + 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// Rows [r0, r0 + 64) of a contiguous (n, HD) slab into a padded float32 tile;
// rows at or past n read as zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int n) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < 64 * HD; e += NT) {
    const int r = e / HD, c = e % HD, gr = r0 + r;
    dst[r * LD + c] = gr < n ? to_f32(src[(int64_t)gr * HD + c]) : 0.f;
  }
}

// s[i][j] = sum_d A[ty * 4 + i][d] * B[tx + 16 j][d] over two padded 64 x HD
// tiles, thread (ty, tx) = (tid / 16, tid % 16).
template <int HD>
__device__ __forceinline__ void tile_abt(const float* A, const float* B, float (&s)[4][4]) {
  constexpr int LD = HD + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// Whether key tile k0 holds a key that some row of query tile q0 may attend.
__device__ __forceinline__ bool tile_reached(int q0, int k0, int causal, int window) {
  if (causal && k0 > q0 + BQ - 1) return false;
  if (window > 0 && !(k0 + BK - 1 > q0 - window)) return false;
  return true;
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int S, int causal, int window) {
  bool ok = qpos < S && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// Per tile, P and dS of one query tile against one key tile: s and dp are
// this thread's raw Q K^T and dO V^T entries; lse_s and d_s the tile rows'
// lse and D; p_out / ds_out (either may be null) the padded score tiles.
__device__ __forceinline__ void probs_and_dscores(const float (&s)[4][4], const float (&dp)[4][4],
                                                 const float* lse_s, const float* d_s, int q0,
                                                 int k0, int S, int causal, int window,
                                                 float sqrt_hd, float* p_out, float* ds_out) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p =
          allowed(q0 + r, k0 + c, S, causal, window) ? expf(s[i][j] / sqrt_hd - lse_s[r]) : 0.f;
      if (p_out) p_out[r * LDS + c] = p;
      ds_out[r * LDS + c] = p * (dp[i][j] - d_s[r]);
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (size_t)((2 * BQ + 2 * BK) * (HD + 1) + 2 * BQ * LDS + 2 * BQ);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)((2 * BQ + 2 * BK) * (HD + 1) + BQ * LDS + 2 * BQ);
}

// D = rowsum(dO * O) for `rows` rows of hd. The rule: TPR threads a row,
// each with one 16-byte load of O and of dO (8 bf16 or 4 float32), summed
// over the row's lanes by shuffles. TPR 0 is the fallback for inputs not
// 16-byte aligned: one warp a row, element by element.
template <typename T, int TPR>
__global__ void __launch_bounds__(NT)
fa_bwd_dsum(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ dsum,
            int64_t rows, int hd) {
  constexpr int LANES = TPR > 0 ? TPR : 32;
  const int64_t row = (int64_t)blockIdx.x * (NT / LANES) + threadIdx.x / LANES;
  const int part = threadIdx.x % LANES;
  const bool in = row < rows;   // every lane stays for the shuffles
  float dot = 0.f;
  if (TPR > 0 && in) {
    constexpr int V = 16 / sizeof(T);
    T ov[V], dv[V];
    *reinterpret_cast<uint4*>(ov) = reinterpret_cast<const uint4*>(o + row * hd)[part];
    *reinterpret_cast<uint4*>(dv) = reinterpret_cast<const uint4*>(dout + row * hd)[part];
#pragma unroll
    for (int e = 0; e < V; ++e) dot = fmaf(to_f32(dv[e]), to_f32(ov[e]), dot);
  } else if (in) {
    for (int c = part; c < hd; c += 32)
      dot = fmaf(to_f32(dout[row * hd + c]), to_f32(o[row * hd + c]), dot);
  }
#pragma unroll
  for (int w = LANES / 2; w > 0; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w, LANES);
  if (part == 0 && in) dsum[row] = dot;
}

template <typename T, int TPR>
cudaError_t launch_dsum_tpr(const void* o, const void* dout, float* dsum, int64_t rows, int hd,
                            cudaStream_t stream) {
  constexpr int LANES = TPR > 0 ? TPR : 32;
  const int64_t blocks = (rows + NT / LANES - 1) / (NT / LANES);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fa_bwd_dsum<T, TPR><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, rows, hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dsum(const void* o, const void* dout, float* dsum, int64_t rows, int hd,
                        cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout)) % 16) == 0;
  switch (aligned ? hd * (int)sizeof(T) / 16 : 0) {
    case 2: return launch_dsum_tpr<T, 2>(o, dout, dsum, rows, hd, stream);
    case 4: return launch_dsum_tpr<T, 4>(o, dout, dsum, rows, hd, stream);
    case 8: return launch_dsum_tpr<T, 8>(o, dout, dsum, rows, hd, stream);
    case 16: return launch_dsum_tpr<T, 16>(o, dout, dsum, rows, hd, stream);
    case 32: return launch_dsum_tpr<T, 32>(o, dout, dsum, rows, hd, stream);
    default: return launch_dsum_tpr<T, 0>(o, dout, dsum, rows, hd, stream);
  }
}

// Loads the lse and D of query tile q0 of slab bh; rows past S read as zeros.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* d_s, const float* lse,
                                               const float* dsum, int64_t bh, int q0, int S) {
  if (threadIdx.x < BQ) {
    const int qpos = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qpos < S ? lse[bh * S + qpos] : 0.f;
    d_s[threadIdx.x] = qpos < S ? dsum[bh * S + qpos] : 0.f;
  }
}

// CUDA cores: dK and dV of one key tile, over the G heads of its group.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv, int H, int KV,
            int S, int causal, int window, float sqrt_hd) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;
  float* dss = ps + BQ * LDS;
  float* lse_s = dss + BQ * LDS;
  float* d_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int64_t kvslab = ((int64_t)b * KV + kvh) * S * HD;
  load_tile<T, HD>(ks, k + kvslab, k0, S);
  load_tile<T, HD>(vs, v + kvslab, k0, S);

  float acc_k[4][DPT], acc_v[4][DPT];  // keys ty * 4 + i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int64_t bh = (int64_t)b * H + kvh * G + g;
    for (int t = 0; t < nq; ++t) {
      const int q0 = t * BQ;
      if (!tile_reached(q0, k0, causal, window)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD>(qs, q + bh * S * HD, q0, S);
      load_tile<T, HD>(dos, dout + bh * S * HD, q0, S);
      load_row_stats(lse_s, d_s, lse, dsum, bh, q0, S);
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_abt<HD>(qs, ks, s);    // rows: queries, columns: keys
      tile_abt<HD>(dos, vs, dp);
      probs_and_dscores(s, dp, lse_s, d_s, q0, k0, S, causal, window, sqrt_hd, ps, dss);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * LDS + ty * 4 + i];
          dsv[i] = dss[r * LDS + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const float dov = dos[r * LD + tx + 16 * j];
          const float qv = qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] = fmaf(pv[i], dov, acc_v[i][j]);
            acc_k[i][j] = fmaf(dsv[i], qv, acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= S) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int64_t off = kvslab + (int64_t)kpos * HD + tx + 16 * j;
      dk[off] = from_f32<T>(acc_k[i][j] / sqrt_hd);
      dv[off] = from_f32<T>(acc_v[i][j]);
    }
  }
}

// CUDA cores: dQ of one query tile of one head.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, T* __restrict__ dq, int H, int KV, int S, int causal,
          int window, float sqrt_hd) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;
  float* lse_s = dss + BQ * LDS;
  float* d_s = lse_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t bh = (int64_t)b * H + h;
  const int64_t kvslab = ((int64_t)b * KV + kvh) * S * HD;
  load_tile<T, HD>(qs, q + bh * S * HD, q0, S);
  load_tile<T, HD>(dos, dout + bh * S * HD, q0, S);
  load_row_stats(lse_s, d_s, lse, dsum, bh, q0, S);

  float acc[4][DPT];  // rows ty * 4 + i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const int nk = (S + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    if (!tile_reached(q0, k0, causal, window)) continue;
    __syncthreads();
    load_tile<T, HD>(ks, k + kvslab, k0, S);
    load_tile<T, HD>(vs, v + kvslab, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_abt<HD>(qs, ks, s);
    tile_abt<HD>(dos, vs, dp);
    probs_and_dscores(s, dp, lse_s, d_s, q0, k0, S, causal, window, sqrt_hd, nullptr, dss);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float kv = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      dq[(bh * S + qpos) * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / sqrt_hd);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                       void* dv, int B, int H, int KV, int S, int causal, int window,
                       float sqrt_hd, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int nt = (S + BQ - 1) / BQ;
  cudaError_t err;
  if ((err = allow_smem(fa_bwd_dkdv<T, HD>, dkdv_smem<HD>())) != cudaSuccess) return err;
  if ((err = allow_smem(fa_bwd_dq<T, HD>, dq_smem<HD>())) != cudaSuccess) return err;
  if ((err = launch_dsum<T>(o, dout, dsum, (int64_t)B * H * S, HD, stream)) != cudaSuccess)
    return err;
  fa_bwd_dkdv<T, HD><<<dim3(nt, KV, B), NT, dkdv_smem<HD>(), stream>>>(
      qt, kt, vt, dop, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), H, KV, S, causal,
      window, sqrt_hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq<T, HD><<<dim3(nt, H, B), NT, dq_smem<HD>(), stream>>>(
      qt, kt, vt, dop, lse, dsum, static_cast<T*>(dq), H, KV, S, causal, window, sqrt_hd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                        void* dv, int B, int H, int KV, int S, int causal, int window,
                        float sqrt_hd, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_bwd<T, 16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, S, causal,
                               window, sqrt_hd, s);
    case 32:
      return launch_bwd<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, S, causal,
                               window, sqrt_hd, s);
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, S, causal,
                               window, sqrt_hd, s);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, S, causal,
                                window, sqrt_hd, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route.

constexpr int BWD_STAGES = 2;       // Q/dO (dK/dV) or K/V (dQ) ring depth
constexpr int BWD_THREADS = 160;    // one consumer warpgroup + one producer warp
constexpr int MAX_GROUP = 8;        // query heads per KV head: the portable cluster size
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ __nv_bfloat16* align_1024(unsigned char* p) {
  return reinterpret_cast<__nv_bfloat16*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// Whether a (query tile q0, key tile k0) pair holds a masked entry.
__device__ __forceinline__ bool tile_edge(int q0, int k0, int S, int causal, int window) {
  return (k0 + BK > S) || (q0 + BQ > S) || (causal && k0 + BK - 1 > q0) ||
         (window > 0 && k0 <= q0 + BQ - 1 - window);
}

// Row stride, in floats, of the dK / dV exchange tile: 8 floats of padding
// make the fragment stores of a half warp fall on distinct banks.
template <int HD>
__host__ __device__ constexpr int red_ld() { return HD + 8; }

template <int HD>
constexpr size_t dkdv_sm90_smem() {
  // K, V, then BWD_STAGES x (Q, dO), each HD / 64 swizzled panels; the
  // stages' lse and D rows; the mbarriers; slack to align to 1024 bytes.
  return (size_t)(2 + 2 * BWD_STAGES) * HD * 64 * 2 + 2 * BWD_STAGES * BQ * sizeof(float) +
         8 * (1 + 2 * BWD_STAGES) + 1024;
}

// dK and dV (float32, 2 x 64 rows of red_ld) overlay the K, V and ring tiles
// once the walk is done.
static_assert(2 * BK * red_ld<128>() * 4 <= (2 + 2 * BWD_STAGES) * 128 * 64 * 2, "dK/dV tile");
static_assert(2 * BK * red_ld<64>() * 4 <= (2 + 2 * BWD_STAGES) * 64 * 64 * 2, "dK/dV tile");

// Grid (H, B, key tiles), clusters of G = H / KV blocks along the heads.
// Accumulator fragment rows are keys, columns queries (see fa_fwd_sm90's
// fragment note): element 4j + 2i + c of a 64 x 64 product is key
// 16 warp + lane / 4 + 8i, query 8j + 2 (lane % 4) + c; of dK / dV, column
// 8j + 2 (lane % 4) + c of head_dim.
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS, HD == 64 ? 2 : 1)
fa_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out, int H,
                 int KV, int S, int causal, int window, float scale) {
  constexpr int NP = HD / 64;          // panels per tile
  constexpr int TILE = NP * PANEL;     // bf16 elements per tile
  constexpr int LDR = red_ld<HD>();
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* base = align_1024(smem_raw);
  __nv_bfloat16* k_s = base;
  __nv_bfloat16* v_s = base + TILE;
  __nv_bfloat16* q_s = base + 2 * TILE;                    // + stage * TILE
  __nv_bfloat16* do_s = base + (2 + BWD_STAGES) * TILE;    // + stage * TILE
  float* lse_s = reinterpret_cast<float*>(base + (2 + 2 * BWD_STAGES) * TILE);  // [stage][BQ]
  float* d_s = lse_s + BWD_STAGES * BQ;                                          // [stage][BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(d_s + BWD_STAGES * BQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;                  // [BWD_STAGES]
  uint64_t* empty = bars + 1 + BWD_STAGES;    // [BWD_STAGES]
  float* red = reinterpret_cast<float*>(base);   // after the walk: dK rows, then dV rows

  cg::cluster_group cluster = cg::this_cluster();
  const int G = H / KV;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / G;
  const int k0 = blockIdx.z * BK;
  const int64_t bh = (int64_t)b * H + h;

  // The query tiles that reach this key tile: [qlo, qlo + n_tiles).
  const int nq = (S + BQ - 1) / BQ;
  int qlo = nq, qhi = 0;
  for (int t = 0; t < nq; ++t)
    if (tile_reached(t * BQ, k0, causal, window)) {
      qlo = min(qlo, t);
      qhi = t + 1;
    }
  const int n_tiles = max(qhi - qlo, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (tid >= 128) {
    // Producer warp: every lane stages lse and D rows, lane 0 the copies.
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * TILE * 2);
      for (int p = 0; p < NP; ++p) {
        tma_load(k_s + p * PANEL, &tm_k, kv_full, 64 * p, k0, b * KV + kvh);
        tma_load(v_s + p * PANEL, &tm_v, kv_full, 64 * p, k0, b * KV + kvh);
      }
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % BWD_STAGES, r = i / BWD_STAGES;
      const int q0 = (qlo + i) * BQ;
      if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
      for (int e = lane; e < BQ; e += 32) {
        const int qpos = q0 + e;
        lse_s[s * BQ + e] = qpos < S ? lse[bh * S + qpos] * LOG2E : 0.f;
        d_s[s * BQ + e] = qpos < S ? dsum[bh * S + qpos] : 0.f;
      }
      __syncwarp();   // the rows are written before lane 0's arrival releases them
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * TILE * 2);
        for (int p = 0; p < NP; ++p) {
          tma_load(q_s + s * TILE + p * PANEL, &tm_q, &full[s], 64 * p, q0, (int)bh);
          tma_load(do_s + s * TILE + p * PANEL, &tm_do, &full[s], 64 * p, q0, (int)bh);
        }
      }
      __syncwarp();
    }
  } else {
    // Consumer warpgroup.
    const int key0 = k0 + 16 * warp + lane / 4;   // keys key0 and key0 + 8
    const int col0 = 2 * (lane % 4);              // + 8j + c within a tile
    const float scale2 = scale * LOG2E;
    float dk[HD / 2], dv[HD / 2];
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dk[e] = dv[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;

    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % BWD_STAGES;
      const int q0 = (qlo + i) * BQ;
      const __nv_bfloat16* qt = q_s + s * TILE;
      const __nv_bfloat16* dot = do_s + s * TILE;
      mbar_wait(&full[s], (i / BWD_STAGES) & 1);
      wgmma_fence();
      wgmma_abt<HD>(st, k_s, qt, false);     // S^T = K Q^T
      wgmma_abt<HD>(dpt, v_s, dot, false);   // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      const float* ls = lse_s + s * BQ;
      const float* ds = d_s + s * BQ;
      const bool edge = tile_edge(q0, k0, S, causal, window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + col0 + (e % 2);
          float p = exp2_approx(st[4 * j + e] * scale2 - ls[col]);
          if (edge && !allowed(q0 + col, key0 + 8 * (e / 2), S, causal, window)) p = 0.f;
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - ds[col]);
        }
      uint32_t pa[4][4], da[4][4];
      pack_frag(pa, st);
      pack_frag(da, dpt);
      wgmma_fence();
      wgmma_ab<HD>(dv, pa, dot);   // dV += P^T dO
      wgmma_ab<HD>(dk, da, qt);    // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Every consumer warp is done with the tiles before they are overwritten.
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    const int row = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (row + 8 * r) * LDR + 8 * j + col0;
        *reinterpret_cast<float2*>(red + off) =
            make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(red + BK * LDR + off) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
  }
  __syncwarp();
  cluster.sync();   // every block's dK and dV are in its shared memory

  // Block `rank` (the head's place in its group) sums its share of the 2 x 64
  // rows over the G blocks, in the order of the heads.
  const int rank = (int)cluster.block_rank();
  const int per = (2 * BK + G - 1) / G;
  const int r0 = rank * per, r1 = min(2 * BK, r0 + per);
  constexpr int C4 = HD / 4;
  for (int it = tid; it < (r1 - r0) * C4; it += BWD_THREADS) {
    const int row = r0 + it / C4, c = (it % C4) * 4;
    const int key = k0 + row % BK;
    if (key >= S) continue;
    // all G loads in flight at once, then the sum in the heads' order
    float4 x[MAX_GROUP];
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      if (g < G)
        x[g] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, (unsigned)g) + row * LDR + c);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int g = 0; g < MAX_GROUP; ++g)
      if (g < G) {
        acc.x += x[g].x;
        acc.y += x[g].y;
        acc.z += x[g].z;
        acc.w += x[g].w;
      }
    const bool is_dk = row < BK;
    const float f = is_dk ? scale : 1.f;
    __nv_bfloat16* dst = (is_dk ? dk_out : dv_out) + (((int64_t)b * KV + kvh) * S + key) * HD + c;
    uint2 packed;
    packed.x = pack_bf16(acc.x * f, acc.y * f);
    packed.y = pack_bf16(acc.z * f, acc.w * f);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

template <int HD>
constexpr size_t dq_sm90_smem() {
  // Q, dO, then BWD_STAGES x (K, V); the mbarriers; slack.
  return (size_t)(2 + 2 * BWD_STAGES) * HD * 64 * 2 + 8 * (1 + 2 * BWD_STAGES) + 1024;
}

// Grid: query tiles x heads x batch, the last query tile of each (b, h)
// first. Fragment rows are queries, columns keys.
template <int HD>
__global__ void __launch_bounds__(BWD_THREADS, 2)
fa_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               __nv_bfloat16* __restrict__ dq_out, int B, int H, int KV, int S, int causal,
               int window, float scale) {
  constexpr int NP = HD / 64;
  constexpr int TILE = NP * PANEL;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* base = align_1024(smem_raw);
  __nv_bfloat16* q_s = base;
  __nv_bfloat16* do_s = base + TILE;
  __nv_bfloat16* k_s = base + 2 * TILE;                   // + stage * TILE
  __nv_bfloat16* v_s = base + (2 + BWD_STAGES) * TILE;    // + stage * TILE
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (2 + 2 * BWD_STAGES) * TILE);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                  // [BWD_STAGES]
  uint64_t* empty = bars + 1 + BWD_STAGES;    // [BWD_STAGES]

  const int nq = (S + BQ - 1) / BQ;
  const int bhi = blockIdx.x % (B * H);
  const int qt = nq - 1 - blockIdx.x / (B * H);
  const int b = bhi / H, h = bhi % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int64_t bh = (int64_t)b * H + h;

  // The reachable key tiles [lo, hi): the forward's rule.
  int hi = (S + BK - 1) / BK;
  if (causal) hi = min(hi, (q0 + BQ - 1) / BK + 1);
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / BK;
  const int n_tiles = max(hi - lo, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    if (tid == 128) {
      mbar_expect_tx(q_full, 2 * TILE * 2);
      for (int p = 0; p < NP; ++p) {
        tma_load(q_s + p * PANEL, &tm_q, q_full, 64 * p, q0, (int)bh);
        tma_load(do_s + p * PANEL, &tm_do, q_full, 64 * p, q0, (int)bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % BWD_STAGES, r = i / BWD_STAGES;
        const int row = (lo + i) * BK, slab = b * KV + kvh;
        if (r > 0) mbar_wait(&empty[s], (r - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE * 2);
        for (int p = 0; p < NP; ++p) {
          tma_load(k_s + s * TILE + p * PANEL, &tm_k, &full[s], 64 * p, row, slab);
          tma_load(v_s + s * TILE + p * PANEL, &tm_v, &full[s], 64 * p, row, slab);
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + 16 * warp + lane / 4;   // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r;
    lse2[r] = qpos < S ? lse[bh * S + qpos] * LOG2E : 0.f;
    dd[r] = qpos < S ? dsum[bh * S + qpos] : 0.f;
  }
  float dq[HD / 2];
  float sc[32], dp[32];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) dq[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % BWD_STAGES;
    const int k0 = (lo + i) * BK;
    const __nv_bfloat16* kt = k_s + s * TILE;
    mbar_wait(&full[s], (i / BWD_STAGES) & 1);
    wgmma_fence();
    wgmma_abt<HD>(sc, q_s, kt, false);               // S = Q K^T
    wgmma_abt<HD>(dp, do_s, v_s + s * TILE, false);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool edge = tile_edge(q0, k0, S, causal, window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(sc[4 * j + e] * scale2 - lse2[e / 2]);
        if (edge && !allowed(row0 + 8 * (e / 2), k0 + 8 * j + col0 + (e % 2), S, causal, window))
          p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - dd[e / 2]);
      }
    uint32_t da[4][4];
    pack_frag(da, dp);
    wgmma_fence();
    wgmma_ab<HD>(dq, da, kt);   // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* qp = dq_out + bh * S * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(qp + (int64_t)qi * HD + 8 * j + col0) =
          pack_bf16(dq[4 * j + 2 * r] * scale, dq[4 * j + 2 * r + 1] * scale);
  }
}

// The tensor maps of q, k, v and dout, in 64 x 64 boxes.
bool make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
               const void* dout, int hd, int B, int H, int KV, int S) {
  return make_map(&m[0], q, hd, S, B * H) && make_map(&m[1], k, hd, S, B * KV) &&
         make_map(&m[2], v, hd, S, B * KV) && make_map(&m[3], dout, hd, S, B * H);
}

template <int HD>
cudaError_t launch_dkdv_sm90(const CUtensorMap (&m)[4], const float* lse, const float* dsum,
                             void* dk, void* dv, int B, int H, int KV, int S, int causal,
                             int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const int nt = (S + BK - 1) / BK;
  if (G > MAX_GROUP || nt > 65535 || B > 65535) return cudaErrorInvalidValue;
  // Set on every launch: the attributes belong to the current device's context.
  cudaError_t err = allow_smem(fa_bwd_dkdv_sm90<HD>, dkdv_sm90_smem<HD>());
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)H, (unsigned)B, (unsigned)nt);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = dkdv_sm90_smem<HD>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fa_bwd_dkdv_sm90<HD>, m[0], m[1], m[2], m[3], lse, dsum,
                           static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
                           KV, S, causal, window, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_sm90(const CUtensorMap (&m)[4], const float* lse, const float* dsum,
                           void* dq, int B, int H, int KV, int S, int causal, int window,
                           float scale, cudaStream_t stream) {
  const long long blocks = (long long)((S + BQ - 1) / BQ) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fa_bwd_dq_sm90<HD>, dq_sm90_smem<HD>());
  if (err != cudaSuccess) return err;
  fa_bwd_dq_sm90<HD><<<(unsigned)blocks, BWD_THREADS, dq_sm90_smem<HD>(), stream>>>(
      m[0], m[1], m[2], m[3], lse, dsum, static_cast<__nv_bfloat16*>(dq), B, H, KV, S, causal,
      window, scale);
  return cudaGetLastError();
}

// A second stream per device, on which the dQ kernel runs beside the dK/dV
// kernel: the dK/dV clusters of G blocks leave SMs that no cluster fits on,
// and dQ's blocks fill them. Two events fork it from the caller's stream
// after D and join it back; a mutex keeps the fork, the launches and the
// join of one call together. Made at first use and kept.
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
constexpr int MAX_DEVICES = 64;
std::mutex side_mutex;
SideStream side_streams[MAX_DEVICES];

cudaError_t side_stream(SideStream** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  SideStream& s = side_streams[dev];
  if (s.stream == nullptr) {
    if ((err = cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming)) != cudaSuccess ||
        (err = cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking)) != cudaSuccess)
      return err;
  }
  *out = &s;
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const float* lse, float* dsum, void* dq, void* dk,
                            void* dv, int B, int H, int KV, int S, int causal, int window,
                            float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  if (!make_maps(m, q, k, v, dout, HD, B, H, KV, S)) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(side_mutex);
  SideStream* side = nullptr;
  cudaError_t err = side_stream(&side);
  if (err != cudaSuccess) return err;
  if ((err = launch_dsum<__nv_bfloat16>(o, dout, dsum, (int64_t)B * H * S, HD, stream)) !=
      cudaSuccess)
    return err;
  if ((err = cudaEventRecord(side->fork, stream)) != cudaSuccess ||
      (err = cudaStreamWaitEvent(side->stream, side->fork, 0)) != cudaSuccess)
    return err;
  if ((err = launch_dkdv_sm90<HD>(m, lse, dsum, dk, dv, B, H, KV, S, causal, window, scale,
                                  stream)) != cudaSuccess)
    return err;
  if ((err = launch_dq_sm90<HD>(m, lse, dsum, dq, B, H, KV, S, causal, window, scale,
                                side->stream)) != cudaSuccess)
    return err;
  if ((err = cudaEventRecord(side->join, side->stream)) != cudaSuccess) return err;
  return cudaStreamWaitEvent(stream, side->join, 0);
}

}  // namespace

// The CUDA-core route. q, o, dout, dq (B, H, S, hd); k, v, dk, dv
// (B, KV, S, hd); lse (B, H, S) float32, the forward's per-row log-sum-exp
// of the scaled scores (natural log); dsum (B, H, S) float32 scratch for D.
// All contiguous; q, k, v, o, dout, dq, dk, dv of one type: dtype 0 is
// float32, 1 is bf16. head_dim 16, 32, 64 or 128 and H a multiple of KV.
// sqrt_hd is sqrt(head_dim) in float32. Launches the three kernels on
// `stream` and returns the first non-zero cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported shape).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* dsum, void* dq, void* dk, void* dv, int B, int H,
                                         int KV, int S, int hd, int causal, int window,
                                         float sqrt_hd, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, S,
                                   causal, window, sqrt_hd, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H,
                                           KV, S, causal, window, sqrt_hd, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route: the same tensors as the CUDA-core route's, all
// bf16 (lse and dsum float32), contiguous and 16-byte aligned; head_dim 64
// or 128, H a multiple of KV with H / KV <= 8; scale is 1 / sqrt(head_dim).
// Launches fa_bwd_dsum and fa_bwd_dkdv_sm90 (clusters of H / KV blocks) on
// `stream` and fa_bwd_dq_sm90 on the device's side stream, which `stream`
// then waits for; returns the first non-zero error (cudaErrorInvalidValue
// for an unsupported shape or a tensor map that cuTensorMapEncodeTiled
// refuses).
extern "C" int repro_flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const float* lse,
                                              float* dsum, void* dq, void* dk, void* dv, int B,
                                              int H, int KV, int S, int hd, int causal,
                                              int window, float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return (int)launch_bwd_sm90<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, S, causal,
                                    window, scale, s);
  if (hd == 128)
    return (int)launch_bwd_sm90<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, H, KV, S,
                                     causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of G dK/dV blocks (head_dim 64 or 128) the current
// device holds at once, into *out (cudaOccupancyMaxActiveClusters), for
// tools/flash_bwd_time.py. Returns the CUDA error.
extern "C" int repro_flash_attention_bwd_dkdv_clusters(int hd, int G, int* out) {
  if (G <= 0 || G > MAX_GROUP || (hd != 64 && hd != 128)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G, 1, 1);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = hd == 64 ? dkdv_sm90_smem<64>() : dkdv_sm90_smem<128>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* kernel =
      hd == 64 ? (const void*)fa_bwd_dkdv_sm90<64> : (const void*)fa_bwd_dkdv_sm90<128>;
  cudaError_t err = hd == 64 ? allow_smem(fa_bwd_dkdv_sm90<64>, dkdv_sm90_smem<64>())
                             : allow_smem(fa_bwd_dkdv_sm90<128>, dkdv_sm90_smem<128>());
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}
