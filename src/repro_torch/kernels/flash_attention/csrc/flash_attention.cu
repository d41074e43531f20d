// Blockwise (flash) attention forward for Hopper (sm_90a), float32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention`, body `_fa_kernel`): causal or sliding-window GQA
// attention with an online softmax whose running max m, sum l and
// accumulator are float32, masks of -1e30, fully masked KV tiles skipped,
// rows with l == 0 written as 0, and scale 1/sqrt(head_dim).
//
// Two kernels, two C entry points; the wrapper (../ops.py) picks one by
// type and head_dim. Both take any Sq and Sk and GQA (query head h reads KV
// head h / (H / KV)).
//
// fa_fwd_sm90 (repro_flash_attention_fwd_sm90): bf16, head_dim 64 or 128,
// on the tensor cores. One block of 160 threads owns one (batch, head,
// 64-row query tile): warps 0-3 are one consumer warpgroup, warp 4 the
// producer. The producer's lane 0 loads Q once and K and V tiles of 64
// keys with TMA (cp.async.bulk.tensor, tensor maps built on the host,
// 128-byte swizzle, rows past Sq or Sk read as zeros) into two rings of two
// stages, K and V apart, each stage with a full and an empty mbarrier: a K
// tile is released as soon as its scores are computed, so the next K load
// starts a whole tile earlier than a V load could. Per KV tile the consumer
// issues the NEXT tile's S = Q K^T (wgmma m64n64k16, both operands from
// shared memory, K-major) and runs this tile's softmax while it computes:
// the mask only on tiles that cross the diagonal, the window edge or Sk,
// the online softmax on the accumulator fragment (row max and sum over the
// four lanes of a quad; scores kept times log2(e) so each exponential is
// one ex2.approx), and P rounded to bf16 in registers as the TPU kernel
// does before its PV product; then O += P V with wgmma m64n{hd}k16, A from
// registers and V as an MN-major (transposed) B operand. Query tiles are
// launched heaviest first (the last tile of a causal row first). The
// epilogue divides by l (1 where l == 0) and stores bf16. The wgmma,
// TMA and mbarrier helpers live in sm90.cuh, shared with the backward.
//
// Both kernels store, when the caller passes an lse pointer, each row's
// log-sum-exp of its masked scaled scores (natural log; +inf where l == 0)
// from the epilogue's m and l, which the backward needs to recompute P
// without a pass of its own; a null pointer leaves prefill as it was.
//
// fa_fwd_kernel (repro_flash_attention_fwd): float32 (every head_dim) and
// bf16 at head_dim 16 or 32, on the CUDA cores. Same block ownership; per
// KV tile of 64 keys:
//   1. K and V are loaded into shared memory, converted to float32;
//   2. S = Q K^T * scale: each of 256 threads computes a 4 x 4 block of the
//      64 x 64 scores with fmaf over head_dim;
//   3. four threads per query row mask S, update m and l, and write
//      P = exp(S - m_new) back to shared memory (expf, not __expf);
//   4. acc = acc * alpha + P V: each thread owns 4 rows x head_dim/16
//      columns of acc.
// Rows and columns of shared tiles are padded by one float so that the
// strided reads of steps 2 and 4 hit distinct banks. Every product and sum
// is IEEE float32 (no TF32, no tensor cores), so float32 inputs meet the
// 1e-5 bound of the reference tests; P stays float32 for the PV product.
//
// Bound. For causal attention at the qwen2-1.5b serving shape (B 4, S 512,
// H 12, KV 2, hd 128, bf16) one call needs 4*hd*B*H*S(S+1)/2 = 3.2 GFLOP,
// 3.3 us at the 989 TFLOP/s bf16 tensor rate, and moves q, k, v and o once,
// 14.7 MB, 4.4 us at 3.35 TB/s; the bytes bound it. On an H100 (700 W)
// fa_fwd_sm90 takes about 0.018 ms there, level with PyTorch's SDPA, and
// 0.023 ms at the hymba-1.5b shape (SDPA 0.021) (chip_smoke.py, device
// times). What holds it back is each block's serial chain, not a unit's
// rate: per KV tile the softmax and the waits for K, V and the products
// follow one another in one warpgroup, and a block's first Q and K loads,
// which every block issues at once, come before any of them. Blocks
// that serve several heads of a GQA group (sharing K and V) and a
// persistent grid that prefetches the next tile's Q were both slower. The
// CUDA-core kernel runs at float32 rate, far from either bound.

#include "sm90.cuh"

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
              const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
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
    if (lse != nullptr && tx == 0)   // +inf where l == 0
      lse[((int64_t)b * H + h) * Sq + qi] = l == 0.f ? __int_as_float(0x7f800000)
                                                     : m_s[r] + logf(l);
    l = (l == 0.f) ? 1.f : l;  // fully masked rows
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      op[(int64_t)qi * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int H, int KV, int Sq, int Sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, H, KV, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int KV, int Sq, int Sk, int causal,
                        int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// fa_fwd_sm90: bf16 on the tensor cores (wgmma), K and V fed by TMA.

constexpr int SM90_STAGES = 2;         // K/V ring depth
constexpr int SM90_THREADS = 160;      // one consumer warpgroup + one producer warp

template <int HD>
constexpr size_t sm90_smem_bytes() {
  // Q, then SM90_STAGES x (K, V), each HD / 64 swizzled panels; then the
  // mbarriers; plus slack to align the tiles to 1024 bytes.
  return (size_t)(1 + 2 * SM90_STAGES) * HD * 64 * 2 + 8 * (1 + 4 * SM90_STAGES) + 1024;
}

// Waits for a K tile and issues S = Q K^T for it (no wait for the
// product).
template <int HD>
__device__ __forceinline__ void issue_scores(float (&sc)[32], const __nv_bfloat16* q_s,
                                             const __nv_bfloat16* kt, uint64_t* full,
                                             uint32_t parity) {
  mbar_wait(full, parity);
  wgmma_fence();
  wgmma_abt<HD>(sc, q_s, kt, false);
  wgmma_commit();
}

// Accumulator fragment of wgmma m64nN (f32), thread t of the warpgroup:
// element 4j + 2i + c is row 16 (t / 32) + (t % 32) / 4 + 8i, column
// 8j + 2 (t % 4) + c. Four such elements over 16 columns are exactly the
// bf16 A fragment of the next m64k16 product, which is how P feeds PV.
// Two blocks per SM at head_dim 128 (shared memory allows no more), three
// at 64 (registers allow no more).
template <int HD>
__global__ void __launch_bounds__(SM90_THREADS, HD == 64 ? 3 : 2)
fa_fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
            float* __restrict__ lse, int B, int H, int KV, int Sq, int Sk, int causal,
            int window, float scale) {
  constexpr int NP = HD / 64;          // panels per tile
  constexpr int TILE = NP * PANEL;     // bf16 elements per Q, K or V tile
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* q_s = base;
  __nv_bfloat16* k_s = base + TILE;                      // + stage * TILE
  __nv_bfloat16* v_s = base + (1 + SM90_STAGES) * TILE;  // + stage * TILE
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (1 + 2 * SM90_STAGES) * TILE);
  // K and V have rings of their own: a K tile is released as soon as its
  // scores are computed, a V tile after its PV product.
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                      // [SM90_STAGES] each
  uint64_t* k_empty = bars + 1 + SM90_STAGES;
  uint64_t* v_full = bars + 1 + 2 * SM90_STAGES;
  uint64_t* v_empty = bars + 1 + 3 * SM90_STAGES;

  // Heaviest query tiles first: block 0 takes the last tile of (b 0, h 0).
  const int nq = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int qt = nq - 1 - blockIdx.x / (B * H);
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q_start = qt * BQ;

  // The reachable KV tiles [lo, hi): the TPU kernel's block rule.
  int hi = (Sk + BK - 1) / BK;
  if (causal) hi = min(hi, (q_start + BQ - 1) / BK + 1);
  int lo = 0;
  if (window > 0 && q_start - window + 1 > 0) lo = (q_start - window + 1) / BK;
  const int n_tiles = max(hi - lo, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < SM90_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // Producer warp: lane 0 issues every copy.
    if (tid == 128) {
      mbar_expect_tx(q_full, TILE * 2);
      for (int p = 0; p < NP; ++p) tma_load(q_s + p * PANEL, &tm_q, q_full, 64 * p, q_start, b * H + h);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % SM90_STAGES, r = i / SM90_STAGES;
        const int row = (lo + i) * BK, slab = b * KV + kvh;
        if (r > 0) mbar_wait(&k_empty[s], (r - 1) & 1);
        mbar_expect_tx(&k_full[s], TILE * 2);
        for (int p = 0; p < NP; ++p)
          tma_load(k_s + s * TILE + p * PANEL, &tm_k, &k_full[s], 64 * p, row, slab);
        if (r > 0) mbar_wait(&v_empty[s], (r - 1) & 1);
        mbar_expect_tx(&v_full[s], TILE * 2);
        for (int p = 0; p < NP; ++p)
          tma_load(v_s + s * TILE + p * PANEL, &tm_v, &v_full[s], 64 * p, row, slab);
      }
    }
    return;
  }

  // Consumer warpgroup. Scores are kept as s * scale * log2(e), so that
  // exp(s * scale - m) is 2^ of the difference; masked entries and the
  // initial m stay -1e30, as in the TPU kernel.
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q_start + 16 * warp + lane / 4;   // rows row0 and row0 + 8
  const int col0 = 2 * (lane % 4);                    // + 8j + c within a tile
  const float scale2 = scale * 1.4426950408889634f;
  float acc[HD / 2];
  float sc[32], sn[32];   // this tile's scores; the next tile's, in flight
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = sn[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};   // this thread's partial row sums

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    issue_scores<HD>(sc, q_s, k_s, &k_full[0], 0);
    wgmma_wait_all();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[0]);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % SM90_STAGES;
    const int k_start = (lo + i) * BK;
    // The next tile's S = Q K^T runs on the tensor cores during this
    // tile's softmax.
    if (i + 1 < n_tiles) {
      const int sn_stage = (i + 1) % SM90_STAGES;
      issue_scores<HD>(sn, q_s, k_s + sn_stage * TILE, &k_full[sn_stage],
                       ((i + 1) / SM90_STAGES) & 1);
    }

    // Scale and mask: only a tile that crosses Sk, the diagonal or the
    // window edge has masked entries.
    const bool edge = (k_start + BK > Sk) || (causal && k_start + BK - 1 > q_start) ||
                      (window > 0 && k_start <= q_start + BQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = row0 + 8 * (e / 2), kpos = k_start + 8 * j + col0 + (e % 2);
          bool ok = kpos < Sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          sc[4 * j + e] = ok ? sc[4 * j + e] * scale2 : NEG_INF;
        }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale2;
    }

    // Online softmax on the fragment; the four lanes of a quad share rows.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mj[8];   // a tree, not a chain of 16 dependent maxima
#pragma unroll
      for (int j = 0; j < 8; ++j) mj[j] = fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) mj[j] = fmaxf(mj[j], mj[j + w]);
      float mx = mj[0];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      alpha[r] = exp2_approx(m_run[r] - m_new);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2_approx(sc[4 * j + 2 * r + c] - m_new);
          sc[4 * j + 2 * r + c] = p;
          sum += p;
        }
      l_run[r] = alpha[r] * l_run[r] + sum;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];

    // P in bf16: 16 keys of the fragment are one A operand of m64k16.
    uint32_t pa[4][4];
    pack_frag(pa, sc);

    // O += P V: V (keys, hd) is MN-major for B.
    mbar_wait(&v_full[s], (i / SM90_STAGES) & 1);
    wgmma_fence();
    wgmma_ab<HD>(acc, pa, v_s + s * TILE);
    wgmma_commit();
    wgmma_wait_all();   // this PV and the next tile's scores
    fence_regs(acc);
    fence_regs(sn);

    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&v_empty[s]);
      if (i + 1 < n_tiles) mbar_arrive(&k_empty[(i + 1) % SM90_STAGES]);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = sn[e];
  }

  // Epilogue: full row sums over the quad, divide, store bf16. The row's
  // log-sum-exp, where asked for, in natural log of the scaled scores: m is
  // kept in log2 units (times log2(e)), so lse = m ln 2 + log l.
  __nv_bfloat16* op = o + ((int64_t)b * H + h) * Sq * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = row0 + 8 * r;
    if (lse != nullptr && qi < Sq && (lane & 3) == 0)
      lse[((int64_t)b * H + h) * Sq + qi] =
          l == 0.f ? __int_as_float(0x7f800000) : m_run[r] * 0.6931471805599453f + logf(l);
    l = (l == 0.f) ? 1.f : l;  // fully masked rows
    if (qi >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / l, acc[4 * j + 2 * r + 1] / l);
      *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)qi * HD + 8 * j + col0) = v;
    }
  }
}


template <int HD>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int H, int KV, int Sq, int Sk, int causal, int window,
                        float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, Sq, B * H) || !make_map(&tk, k, HD, Sk, B * KV) ||
      !make_map(&tv, v, HD, Sk, B * KV))
    return cudaErrorInvalidValue;
  const size_t smem = sm90_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fa_fwd_sm90<HD><<<(unsigned)blocks, SM90_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, H, KV, Sq, Sk, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core kernel: q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o
// (B, H, Sq, hd), all contiguous and of one type: dtype 0 is float32, 1 is
// bf16. head_dim is 16, 32, 64 or 128 and H is a multiple of KV. lse, if not
// null, is a float32 (B, H, Sq) that receives each row's log-sum-exp of its
// masked scaled scores, natural log (+inf for a row with no unmasked score,
// so that every exp(s - lse) recomputed from it is 0). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported shape).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, float* lse, int B, int H, int KV, int Sq,
                                         int Sk, int hd, int causal, int window, float scale,
                                         int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(hd, q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window,
                                   scale, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, H, KV, Sq, Sk, causal,
                                           window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o
// (B, H, Sq, hd), all bf16, contiguous and 16-byte aligned; head_dim 64 or
// 128 and H a multiple of KV; lse as for the CUDA-core kernel. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported shape or a tensor map that cuTensorMapEncodeTiled refuses,
// such as one at an address not 16-byte aligned).
extern "C" int repro_flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                                              void* o, float* lse, int B, int H, int KV,
                                              int Sq, int Sk, int hd, int causal, int window,
                                              float scale, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return (int)launch_sm90<64>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window, scale, s);
  if (hd == 128)
    return (int)launch_sm90<128>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
