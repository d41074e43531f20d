// Flash-attention backward for Hopper (sm_90a), float32 or bf16, on the CUDA cores.
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
// with every product and sum in IEEE float32 (no TF32, no tensor cores) and
// dq, dk, dv stored in the input type. Three kernels, launched in order by one
// C entry point; each keeps its tiles in shared memory as float32, rows padded
// by one float so that the strided reads hit distinct banks, and skips the
// tiles that the mask cannot reach (the forward kernels' block rule):
//
//   1. fa_bwd_prep, grid (query tiles, H, B): per query row the log-sum-exp
//      lse = m + log l of its scores, by one pass over the reachable key tiles
//      (the online max and sum of the forward; expf, not __expf), and
//      D = rowsum(dO * O). Both float32, in scratch the wrapper allocates.
//   2. fa_bwd_dkdv, grid (key tiles, KV, B): a block holds one 64-key tile of
//      K and V and walks the query tiles of all G heads of its group that the
//      mask reaches; per tile it recomputes S = Q K^T and dP = dO V^T (each of
//      256 threads a 4 x 4 block), P = exp(S - lse) and dS = P (dP - D) into
//      shared memory, then adds P^T dO and dS^T Q into dV and dK, held in
//      registers (4 keys x hd / 16 columns a thread). A block owns its dK and
//      dV, so there are no atomics and the result does not depend on the order
//      in which blocks run.
//   3. fa_bwd_dq, grid (query tiles, H, B): a block holds one 64-row tile of Q
//      and dO and walks the reachable key tiles: S, dP and dS as in 2, then
//      dQ += dS K in registers.
//
// Bound. At the qwen2-1.5b training shape (B 4, S 512, H 12, KV 2, hd 128,
// causal, bf16) the backward needs five products of hd per attended pair
// (the recomputed Q K^T, dV, dP, dK, dQ): 6.30 M pairs x 5 x 2 x 128 = 8.07
// GFLOP, 0.0082 ms at the 989 TFLOP/s bf16 tensor rate, and it moves q, o,
// dO, k, v in and dq, dk, dv out once, 29.4 MB, 0.0088 ms at 3.35 TB/s: the
// bytes bound it, the operations nearly so. This kernel recomputes Q K^T in
// all three stages and dP in two (eight products of hd per pair, not five)
// and runs them at the float32 rate of the CUDA cores, 67 TFLOP/s at most,
// so it is far from that bound by design; its time on the card is in
// PERF.md. A redesign on the tensor cores (wgmma, TMA, lse from the
// forward's epilogue) is ROADMAP work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block
constexpr int LDS = BK + 1;
constexpr float NEG_INF = -1e30f;

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
constexpr size_t prep_smem() {
  return sizeof(float) * (size_t)((BQ + BK) * (HD + 1) + BQ * LDS + 2 * BQ);
}
template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (size_t)((2 * BQ + 2 * BK) * (HD + 1) + 2 * BQ * LDS + 2 * BQ);
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)((2 * BQ + 2 * BK) * (HD + 1) + BQ * LDS + 2 * BQ);
}

// Stage 1: lse and D per query row.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_bwd_prep(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
            const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ dsum, int H,
            int KV, int S, int causal, int window, float sqrt_hd) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* ps = ks + BK * LD;
  float* m_s = ps + BQ * LDS;
  float* l_s = m_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t bh = (int64_t)b * H + h;
  const T* kp = k + ((int64_t)b * KV + kvh) * S * HD;
  load_tile<T, HD>(qs, q + bh * S * HD, q0, S);
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int r = tid >> 2, part = tid & 3, qpos = q0 + r;  // four threads a row

  const int nk = (S + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    if (!tile_reached(q0, k0, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(ks, kp, k0, S);
    __syncthreads();
    float s[4][4];
    tile_abt<HD>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * LDS + tx + 16 * j] = s[i][j] / sqrt_hd;
    __syncthreads();

    float vals[BK / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = part + 4 * j;
      vals[j] = allowed(qpos, k0 + c, S, causal, window) ? ps[r * LDS + c] : NEG_INF;
      mx = fmaxf(mx, vals[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) sum += expf(vals[j] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    __syncwarp();  // every lane of the row has read m_s[r]
    if (part == 0) {
      l_s[r] = expf(m_prev - m_new) * l_s[r] + sum;
      m_s[r] = m_new;
    }
  }
  __syncthreads();

  float dot = 0.f;
  if (qpos < S) {
    const T* orow = o + (bh * S + qpos) * HD;
    const T* drow = dout + (bh * S + qpos) * HD;
    for (int c = part; c < HD; c += 4) dot = fmaf(to_f32(drow[c]), to_f32(orow[c]), dot);
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  if (part == 0 && qpos < S) {
    const float l = l_s[r] == 0.f ? 1.f : l_s[r];  // fully masked rows
    lse[bh * S + qpos] = m_s[r] + logf(l);
    dsum[bh * S + qpos] = dot;
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

// Stage 2: dK and dV of one key tile, over the G heads of its group.
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

// Stage 3: dQ of one query tile of one head.
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
                       const void* dout, float* lse, float* dsum, void* dq, void* dk, void* dv,
                       int B, int H, int KV, int S, int causal, int window, float sqrt_hd,
                       cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int nt = (S + BQ - 1) / BQ;
  cudaError_t err;
  if ((err = allow_smem(fa_bwd_prep<T, HD>, prep_smem<HD>())) != cudaSuccess) return err;
  if ((err = allow_smem(fa_bwd_dkdv<T, HD>, dkdv_smem<HD>())) != cudaSuccess) return err;
  if ((err = allow_smem(fa_bwd_dq<T, HD>, dq_smem<HD>())) != cudaSuccess) return err;

  fa_bwd_prep<T, HD><<<dim3(nt, H, B), NT, prep_smem<HD>(), stream>>>(
      qt, kt, static_cast<const T*>(o), dop, lse, dsum, H, KV, S, causal, window, sqrt_hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
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
                        const void* dout, float* lse, float* dsum, void* dq, void* dk, void* dv,
                        int B, int H, int KV, int S, int causal, int window, float sqrt_hd,
                        cudaStream_t s) {
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

}  // namespace

// q, o, dout, dq (B, H, S, hd); k, v, dk, dv (B, KV, S, hd); lse and dsum
// (B, H, S) float32 scratch. All contiguous; q, k, v, o, dout, dq, dk, dv of
// one type: dtype 0 is float32, 1 is bf16. head_dim 16, 32, 64 or 128 and H a
// multiple of KV. sqrt_hd is sqrt(head_dim) in float32. Launches the three
// stages on `stream` and returns the first non-zero cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported shape).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, float* lse,
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
