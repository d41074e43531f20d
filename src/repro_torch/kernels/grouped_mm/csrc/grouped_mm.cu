// Grouped expert products for Hopper (sm_90a): bf16 in and out, float32
// accumulation on the tensor cores (wgmma), operands fed by TMA.
//
// The rows of a MoE layer are sorted by expert, so expert e owns the
// contiguous segment [offs[e], offs[e + 1]) of them; `offs` (E + 1 int32)
// stays on the device and every kernel reads it there.
//
// grouped_mm_vm (variable M; repro_grouped_mm): out[r] = x[r] @ W[e] for
// every row r of expert e's segment, W (E, K, N) read as an MN-major B
// operand, or out[r] = x[r] @ W[e]^T with W (E, N, K) read K-major
// (TRANS_B): the forward's products and the input gradient. The grid
// holds ceil(M / 128) + E tile slots along y, an upper bound of the sum
// over experts of ceil(M_e / 128); a block's slot becomes (expert, tile)
// by a warp scan over the segments' tile counts, and spare slots exit.
//
// grouped_mm_vk (variable K; repro_grouped_mm_wgrad): out[e] = x_e^T dy_e
// (E, K, N), the sum over expert e's rows of their outer products: the
// weight gradient. The block's K loop runs over the segment's rows in
// tiles of 64; the rows past the segment in the last tile (another
// expert's) are zeroed in shared memory before the product, and an empty
// segment stores zeros.
//
// Both: one block of 288 threads owns a 128 x 128 output tile: warps 0-7
// are two consumer warpgroups of 64 rows each, warp 8 the producer, whose
// lane 0 loads 64-deep K slices of both operands with TMA (64 x 64 boxes,
// 128-byte swizzle, coordinates past a tensor's end read as zeros) into a
// ring of STAGES stages, each with a full and an empty mbarrier. Each
// consumer issues four wgmma m64n128k16 per stage, keeps one stage's
// products in flight and releases the stage before. The epilogue rounds
// the float32 accumulators to bf16 and stores the rows and columns inside
// the output (and, in grouped_mm_vm, inside the segment). Inner
// dimensions must be multiples of 8 (16-byte TMA strides).

#include "../../flash_attention/csrc/sm90.cuh"

namespace {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BKT = 64;       // K per stage
constexpr int STAGES = 4;
constexpr int THREADS = 288;  // two consumer warpgroups + one producer warp
constexpr int STAGE_ELEMS = 4 * PANEL;  // A (2 panels) + B (2 panels)

constexpr size_t smem_bytes() {
  return (size_t)STAGES * STAGE_ELEMS * 2 + 8 * 2 * STAGES + 1024;
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), both from shared memory;
// TA / TB 1 for an MN-major (transposed) operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The four k16 steps of one stage for consumer warpgroup `wg`. A holds the
// block's 128 rows as two panels (K-major: 64 rows x 64 K each; MN-major:
// 64 K x 64 rows each), B its 128 columns as two panels (K-major: 64
// columns x 64 K each, 1024 bytes per 8 columns throughout; MN-major: 64 K
// x 64 columns each, PANEL * 2 bytes apart).
template <int TA, int TB>
__device__ __forceinline__ void stage_products(float (&acc)[64], const __nv_bfloat16* a,
                                               const __nv_bfloat16* b, int wg) {
  const __nv_bfloat16* aw = a + wg * PANEL;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = TA ? smem_desc(aw + kk * 16 * 64, PANEL * 2, 1024)
                           : smem_desc(aw + kk * 16, 16, 1024);
    const uint64_t db = TB ? smem_desc(b + kk * 16 * 64, PANEL * 2, 1024)
                           : smem_desc(b + kk * 16, 16, 1024);
    wgmma_m64n128k16_ss<TA, TB>(acc, da, db);
  }
}

// Stores the warpgroup's 64 x 128 accumulator as bf16: fragment element
// 4j + 2i + c is row 16 (warp % 4) + lane / 4 + 8i, column 8j + 2 (lane % 4)
// + c (fa_fwd_sm90's layout). Rows at or past `rows`, columns at or past
// `cols` are not stored.
__device__ __forceinline__ void store_tile(const float (&acc)[64], __nv_bfloat16* out,
                                           int64_t ld, int rows, int cols, int warp,
                                           int lane) {
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + c0;
      if (c < cols)
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r * ld + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

struct Ring {
  __nv_bfloat16* tiles;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Ring ring_init(unsigned char* smem_raw) {
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_ELEMS);
  Ring r{base, bars, bars + STAGES};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The consumer side of the ring over n_k stages: waits for each stage,
// issues its products, and releases the stage before once its products
// are done. `prep(s, kt)` runs on a landed stage before its products (the
// zeroing of grouped_mm_vk's tail).
template <int TA, int TB, typename Prep>
__device__ __forceinline__ void consume(float (&acc)[64], const Ring& r, int n_k, int wg,
                                        int lane, Prep prep) {
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&r.full[s], (kt / STAGES) & 1);
    prep(s, kt);
    wgmma_fence();
    const __nv_bfloat16* st = r.tiles + s * STAGE_ELEMS;
    stage_products<TA, TB>(acc, st, st + 2 * PANEL, wg);
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&r.empty[(kt - 1) % STAGES]);
    }
  }
  wgmma_wait_all();
  fence_regs(acc);
}

// The producer's wait for a free stage and its byte count.
__device__ __forceinline__ void claim(const Ring& r, int kt) {
  const int s = kt % STAGES, round = kt / STAGES;
  if (round > 0) mbar_wait(&r.empty[s], (round - 1) & 1);
  mbar_expect_tx(&r.full[s], STAGE_ELEMS * 2);
}

template <bool TRANS_B>
__global__ void __launch_bounds__(THREADS, 1)
grouped_mm_vm(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
              const int* __restrict__ offs, __nv_bfloat16* __restrict__ out, int K, int N,
              int E) {
  __shared__ int tile_e, tile_m;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) tile_e = -1;
  __syncthreads();
  if (warp == 0) {
    // slot blockIdx.y -> (expert, row tile): exclusive scan of the tile counts
    int before = 0;
    for (int c = 0; c < E; c += 32) {
      const int e = c + lane;
      const int rows = e < E ? offs[e + 1] - offs[e] : 0;
      const int t = (rows + BM - 1) / BM;
      int incl = t;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const int start = before + incl - t;
      if (t > 0 && (int)blockIdx.y >= start && (int)blockIdx.y < start + t) {
        tile_e = e;
        tile_m = blockIdx.y - start;
      }
      before += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  const int e = tile_e;
  if (e < 0) return;
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int seg0 = offs[e], seg_rows = offs[e + 1] - seg0;
  const int row0 = seg0 + tile_m * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + BKT - 1) / BKT;

  if (warp == 8) {
    if (lane == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        claim(r, kt);
        const int s = kt % STAGES, k0 = kt * BKT;
        __nv_bfloat16* a = r.tiles + s * STAGE_ELEMS;
        __nv_bfloat16* b = a + 2 * PANEL;
        for (int p = 0; p < 2; ++p) {
          tma_load(a + p * PANEL, &tm_x, &r.full[s], k0, row0 + 64 * p, 0);
          if (TRANS_B)
            tma_load(b + p * PANEL, &tm_w, &r.full[s], k0, n0 + 64 * p, e);
          else
            tma_load(b + p * PANEL, &tm_w, &r.full[s], n0 + 64 * p, k0, e);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  consume<0, TRANS_B ? 0 : 1>(acc, r, n_k, wg, lane, [](int, int) {});
  const int rows_left = seg_rows - tile_m * BM - 64 * wg;
  store_tile(acc, out + (int64_t)(row0 + 64 * wg) * N + n0, N, rows_left, N - n0, warp, lane);
}

__global__ void __launch_bounds__(THREADS, 1)
grouped_mm_vk(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dy,
              const int* __restrict__ offs, __nv_bfloat16* __restrict__ out, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int e = blockIdx.z;
  const int seg0 = offs[e], seg_rows = offs[e + 1] - seg0;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (seg_rows + BKT - 1) / BKT;

  if (warp == 8) {
    if (lane == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        claim(r, kt);
        const int s = kt % STAGES, k0 = seg0 + kt * BKT;
        __nv_bfloat16* a = r.tiles + s * STAGE_ELEMS;
        __nv_bfloat16* b = a + 2 * PANEL;
        for (int p = 0; p < 2; ++p) {
          tma_load(a + p * PANEL, &tm_x, &r.full[s], m0 + 64 * p, k0, 0);
          tma_load(b + p * PANEL, &tm_dy, &r.full[s], n0 + 64 * p, k0, 0);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int tail = seg_rows - (n_k - 1) * BKT;  // rows of the last stage in the segment
  consume<1, 1>(acc, r, n_k, wg, lane, [&](int s, int kt) {
    if (kt != n_k - 1 || tail == BKT) return;
    // the rows past the segment, 128 bytes each in all four panels: the
    // swizzle permutes 16-byte chunks within a row only
    uint4* st = reinterpret_cast<uint4*>(r.tiles + s * STAGE_ELEMS);
    const int per_panel = (BKT - tail) * 8;
    for (int i = tid; i < 4 * per_panel; i += 256) {
      const int p = i / per_panel, c = i % per_panel;
      st[p * (PANEL / 8) + tail * 8 + c] = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  });
  store_tile(acc, out + ((int64_t)e * K + m0 + 64 * wg) * N + n0, N, K - m0 - 64 * wg, N - n0,
             warp, lane);
}

// Makes the current device's primary context current on the calling
// thread: cuTensorMapEncodeTiled fails on a thread that has none yet (the
// autograd engine's, whose first CUDA call may be this backward).
cudaError_t bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

cudaError_t set_smem(const void* fn) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes());
}

}  // namespace

// x (M, K) bf16, its rows sorted by expert; offs (E + 1) int32 on the
// device, offs[0] = 0 and offs[E] = M; w (E, K, N) bf16, or (E, N, K) with
// trans_w; out (M, N) bf16 = each row times its expert's w (w^T with
// trans_w). All contiguous and 16-byte aligned, K and N multiples of 8.
// Returns cudaGetLastError() after the launch: cudaErrorInvalidValue for an
// unsupported shape, -2 or -3 where cuTensorMapEncodeTiled refuses the map
// of the first or the second operand.
extern "C" int repro_grouped_mm(const void* x, const void* w, const int* offs, void* out, int M,
                                int K, int N, int E, int trans_w, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tx, tw;
  if (!make_map(&tx, x, K, M, 1)) return -2;
  if (!(trans_w ? make_map(&tw, w, K, N, E) : make_map(&tw, w, N, K, E))) return -3;
  const void* fn = trans_w ? (const void*)grouped_mm_vm<true> : (const void*)grouped_mm_vm<false>;
  err = set_smem(fn);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (trans_w)
    grouped_mm_vm<true><<<grid, THREADS, smem_bytes(), s>>>(tx, tw, offs, o, K, N, E);
  else
    grouped_mm_vm<false><<<grid, THREADS, smem_bytes(), s>>>(tx, tw, offs, o, K, N, E);
  return (int)cudaGetLastError();
}

// x (M, K) and dy (M, N) bf16, rows sorted by expert as offs says; out
// (E, K, N) bf16, out[e] = x_e^T dy_e over expert e's rows (zeros for an
// expert with none). Same conditions and return as repro_grouped_mm.
extern "C" int repro_grouped_mm_wgrad(const void* x, const void* dy, const int* offs, void* out,
                                      int M, int K, int N, int E, void* stream) {
  if (M < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)E * K * N * 2, s);
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tx, tdy;
  if (!make_map(&tx, x, K, M, 1)) return -2;
  if (!make_map(&tdy, dy, N, M, 1)) return -3;
  err = set_smem((const void*)grouped_mm_vk);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, E);
  grouped_mm_vk<<<grid, THREADS, smem_bytes(), s>>>(tx, tdy, offs, static_cast<__nv_bfloat16*>(out),
                                                    K, N);
  return (int)cudaGetLastError();
}
