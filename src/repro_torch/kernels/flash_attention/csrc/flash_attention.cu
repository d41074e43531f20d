// Blockwise (flash) attention forward for Hopper (sm_90a), float32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention`, body `_fa_kernel`): causal or sliding-window GQA
// attention with an online softmax whose running max m, sum l and
// accumulator are float32, masks of -1e30, fully masked KV tiles skipped,
// rows with l == 0 written as 0, and scale 1/sqrt(head_dim).
//
// Design. The TPU kernel walks the KV blocks as the last, sequential grid
// axis and carries m, l and acc in VMEM scratch between grid steps. A Hopper
// grid has no sequential axis, so here one thread block owns one
// (batch, head, 64-row query tile) and runs the KV loop itself, keeping
// m and l in shared memory and acc in registers. Per KV tile of 64 keys:
//   1. K and V are loaded into shared memory, converted to float32;
//   2. S = Q K^T * scale: each of 256 threads computes a 4 x 4 block of the
//      64 x 64 scores with fmaf over head_dim;
//   3. four threads per query row mask S, update m and l, and write
//      P = exp(S - m_new) back to shared memory (expf, not __expf);
//   4. acc = acc * alpha + P V: each thread owns 4 rows x head_dim/16
//      columns of acc.
// Rows and columns of shared tiles are padded by one float so that the
// strided reads of steps 2 and 4 hit distinct banks. GQA maps query head h
// to KV head h / (H / KV). Query rows and keys beyond Sq and Sk are zeros
// and masked, so any sequence length is taken.
//
// Numbers. Every product and sum is IEEE float32 on the CUDA cores (no
// TF32, no tensor cores), so float32 inputs meet the 1e-5 bound of the
// reference tests. P stays float32 for the PV product (the TPU kernel
// rounds it to the input type first), which is as close or closer to the
// plain version.
//
// Bound. For causal attention at the serving shape (B 4, S 512, H 12,
// KV 2, hd 128, bf16) one call needs 4*hd*B*H*S(S+1)/2 = 3.2 GFLOP, 3.3 us
// at the 989 TFLOP/s bf16 tensor rate, and moves q, k, v and o once,
// 14.7 MB, 4.4 us at 3.35 TB/s; the bytes bound it. This kernel runs on the
// CUDA cores at float32 rate, far from either: wgmma, TMA and a pipelined
// KV ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per KV tile
constexpr int NT = 256;   // threads per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              int H, int KV, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int LD = HD + 1;     // padded row stride of the Q, K, V tiles
  constexpr int LDS = BK + 1;    // padded row stride of the score tile
  constexpr int DPT = HD / 16;   // acc columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;
  float* m_s = ps + BQ * LDS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qp = q + ((int64_t)b * H + h) * Sq * HD;
  const T* kp = k + ((int64_t)b * KV + kvh) * Sk * HD;
  const T* vp = v + ((int64_t)b * KV + kvh) * Sk * HD;
  T* op = o + ((int64_t)b * H + h) * Sq * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, c = e % HD, qi = q_start + r;
    qs[r * LD + c] = qi < Sq ? to_f32(qp[(int64_t)qi * HD + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;  // rows ty*4+i, cols tx+16*j
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  const int nk = (Sk + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k_start = t * BK;
    // block-level reachability, the TPU kernel's rule; uniform per block
    if (causal && k_start > q_start + BQ - 1) continue;
    if (window > 0 && !(k_start + BK - 1 > q_start - window)) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, c = e % HD, ki = k_start + r;
      const bool in = ki < Sk;
      ks[r * LD + c] = in ? to_f32(kp[(int64_t)ki * HD + c]) : 0.f;
      vs[r * LD + c] = in ? to_f32(vp[(int64_t)ki * HD + c]) : 0.f;
    }
    __syncthreads();

    // 2. scores
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * LDS + tx + 16 * j] = s[i][j] * scale;
    }
    __syncthreads();

    // 3. mask and online softmax, four threads per row
    {
      const int r = tid >> 2, part = tid & 3;
      const int qpos = q_start + r;
      float vals[BK / 4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int c = part + 4 * j, kpos = k_start + c;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        vals[j] = ok ? ps[r * LDS + c] : NEG_INF;
        mx = fmaxf(mx, vals[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float p = expf(vals[j] - m_new);
        ps[r * LDS + part + 4 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read m_s[r]
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = vs[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q_start + r;
    if (qi >= Sq) continue;
    float l = l_s[r];
    l = (l == 0.f) ? 1.f : l;  // fully masked rows
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      op[(int64_t)qi * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KV, int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Sk, int causal, int window,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o (B, H, Sq, hd), all
// contiguous and of one type: dtype 0 is float32, 1 is bf16. head_dim is
// 16, 32, 64 or 128 and H is a multiple of KV. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported shape).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, int B, int H, int KV, int Sq, int Sk,
                                         int hd, int causal, int window, float scale,
                                         int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, o, B, H, KV, Sq, Sk, causal, window, scale, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                                           scale, s);
  return (int)cudaErrorInvalidValue;
}
