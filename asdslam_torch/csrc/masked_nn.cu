// Fused masked nearest-neighbour search for Hopper (sm_90a).
//
// Replaces asdslam_tpu/ops/pallas_match.py::_kernel (launched by masked_nn,
// pallas_match.py:154).  For each row i of A and every column j of B:
//
//   d(i, j) = |a_i|^2 + |b_j|^2 - 2 a_i.b_j      (dot of bf16-rounded values,
//                                                 summed in f32; norms f32)
//   gated in  iff  dx^2 + dy^2 <= rad2[i],  valid_a[i] && valid_b[j],
//                  dmin <= lvl_b[j] - lvl_a[i] <= dmax
//   gated-in pairs take max(d, 0); gated-out pairs take BIG = 1e30.
//
// Per row it returns idx (the first-occurrence argmin), best, and second
// (the min over every column but idx, so a duplicate column gives
// second == best).  The [N, M] matrix is never written.
//
// Design.  One block owns TR = 32 rows and walks every column tile of
// TC = 64 itself (the TPU kernel instead carried the top-2 between grid
// steps in a revisited output block; here blocks run in parallel and in no
// order, so the column loop lives inside the block).  The block's A rows
// and each B tile are staged in shared memory as bf16-rounded f32.  Warp w
// owns rows w, w+8, w+16, w+24; lane l owns columns l and l+32 of each tile,
// so every thread scans its columns in increasing order and keeps a running
// (best, idx, second) per row in registers:
//     d < best         -> second = best; best = d; idx = j
//     else d < second  -> second = d
// At the end the 32 lanes of a row merge by shuffles, the lower column
// index winning ties.  The gate and distance arithmetic uses
// non-contracting intrinsics so it rounds exactly as the plain PyTorch
// version; only the order of the 128-term dot differs (~1e-6).
//
// Bound at the main-path shapes (H100 SXM, dense peaks):
//   motion search, 2000 x 2000 x 128: 2*2000*2000*128 = 1.0 GFLOP of bf16
//     product, ~1 us at 989 TFLOP/s, plus ~4M gated elements on the CUDA
//     cores; local-map search, 8192 x 2000: ~4.2 GFLOP (~4 us), ~16M gated
//     elements.  Bytes: 1-2.6 MB of descriptors, ~1 us at 3.35 TB/s.
// Both are far below one launch's overhead.  This first version does the
// dot as scalar f32 FMAs on the CUDA cores (no tensor cores), so it is
// bound by shared-memory loads feeding those FMAs, not by either limit
// above; wgmma and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;         // descriptor width
constexpr int TR = 32;         // rows per block
constexpr int TC = 64;         // columns per tile
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPT = TR / WARPS;  // rows per thread (4)
constexpr int CPT = TC / 32;     // columns per thread per tile (2)
constexpr int BSTRIDE = D + 4;   // padded B row: conflict-free float4 reads
constexpr float BIG = 1e30f;
constexpr size_t SMEM_BYTES = (size_t)(TR * D + TC * BSTRIDE) * sizeof(float);

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Merge the running top-2 (b2, i2, s2) into (b, i, s); ties -> lower index.
__device__ __forceinline__ void merge(float& b, int& i, float& s,
                                      float b2, int i2, float s2) {
  const bool take = (b2 < b) || (b2 == b && i2 < i);
  const float loser = take ? b : b2;
  s = fminf(fminf(s, s2), loser);
  if (take) {
    b = b2;
    i = i2;
  }
}

__global__ void __launch_bounds__(THREADS)
masked_nn_kernel(const float* __restrict__ desc_a, const float* __restrict__ desc_b,
                 const float* __restrict__ a2, const float* __restrict__ b2,
                 const float* __restrict__ uv_a, const float* __restrict__ uv_b,
                 const float* __restrict__ rad2,
                 const uint8_t* __restrict__ valid_a, const uint8_t* __restrict__ valid_b,
                 const int32_t* __restrict__ lvl_a, const int32_t* __restrict__ lvl_b,
                 int n, int m, float dmin, float dmax,
                 int32_t* __restrict__ out_idx, float* __restrict__ out_best,
                 float* __restrict__ out_second) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;            // [TR][D]
  float* Bs = smem + TR * D;   // [TC][BSTRIDE]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * TR;

  for (int e = tid; e < TR * D; e += THREADS) {
    const int gr = row0 + e / D;
    As[e] = gr < n ? bf16_round(desc_a[(size_t)gr * D + e % D]) : 0.f;
  }

  float ra2[RPT], rx[RPT], ry[RPT], rr2[RPT], rl[RPT];
  bool rv[RPT];
  float best[RPT], second[RPT];
  int idx[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gr = row0 + warp + WARPS * i;
    const bool in = gr < n;
    ra2[i] = in ? a2[gr] : 0.f;
    rx[i] = in ? uv_a[2 * gr] : 0.f;
    ry[i] = in ? uv_a[2 * gr + 1] : 0.f;
    rr2[i] = in ? rad2[gr] : 0.f;
    rl[i] = in ? (float)lvl_a[gr] : 0.f;
    rv[i] = in && valid_a[gr] != 0;
    best[i] = __int_as_float(0x7f800000);  // +inf: the first column always wins
    second[i] = __int_as_float(0x7f800000);
    idx[i] = -1;
  }

  for (int c0 = 0; c0 < m; c0 += TC) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < TC * D; e += THREADS) {
      const int c = e / D, k = e % D;
      const int gc = c0 + c;
      Bs[c * BSTRIDE + k] = gc < m ? bf16_round(desc_b[(size_t)gc * D + k]) : 0.f;
    }
    __syncthreads();

    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

#pragma unroll 4
    for (int k = 0; k < D; k += 4) {
      float4 a[RPT], b[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(&As[(warp + WARPS * i) * D + k]);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        b[j] = *reinterpret_cast<const float4*>(&Bs[(lane + 32 * j) * BSTRIDE + k]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < CPT; ++j) {  // increasing column order
      const int gc = c0 + lane + 32 * j;
      if (gc >= m) continue;
      const float cb2 = b2[gc];
      const float cx = uv_b[2 * gc];
      const float cy = uv_b[2 * gc + 1];
      const float cl = (float)lvl_b[gc];
      const bool cv = valid_b[gc] != 0;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float dx = __fsub_rn(rx[i], cx);
        const float dy = __fsub_rn(ry[i], cy);
        const float ld = __fsub_rn(cl, rl[i]);
        const bool ok = rv[i] && cv &&
                        __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= rr2[i] &&
                        ld >= dmin && ld <= dmax;
        const float dd = __fsub_rn(__fadd_rn(ra2[i], cb2), __fmul_rn(2.f, acc[i][j]));
        const float d = ok ? fmaxf(dd, 0.f) : BIG;
        if (d < best[i]) {
          second[i] = best[i];
          best[i] = d;
          idx[i] = gc;
        } else if (d < second[i]) {
          second[i] = d;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[i], off);
      merge(best[i], idx[i], second[i], ob, oi, os);
    }
    const int gr = row0 + warp + WARPS * i;
    if (lane == 0 && gr < n) {
      out_idx[gr] = idx[i];
      out_best[gr] = best[i];
      out_second[gr] = fminf(second[i], BIG);  // a single column leaves +inf
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers to contiguous arrays: desc_a [n, d] f32, desc_b [m, d] f32,
// a2 [n], b2 [m], uv_a [n, 2], uv_b [m, 2], rad2 [n] f32, valid_a [n] and
// valid_b [m] bool (one byte), lvl_a [n], lvl_b [m] int32; outputs
// out_idx [n] int32, out_best [n], out_second [n] f32.  Launches on `stream`
// without synchronising; returns the cudaError_t of the launch.
extern "C" int masked_nn_launch(const float* desc_a, const float* desc_b,
                                const float* a2, const float* b2,
                                const float* uv_a, const float* uv_b, const float* rad2,
                                const uint8_t* valid_a, const uint8_t* valid_b,
                                const int32_t* lvl_a, const int32_t* lvl_b,
                                int n, int m, int d, float dmin, float dmax,
                                int32_t* out_idx, float* out_best, float* out_second,
                                void* stream) {
  if (d != D || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      masked_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + TR - 1) / TR);
  masked_nn_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      desc_a, desc_b, a2, b2, uv_a, uv_b, rad2, valid_a, valid_b, lvl_a, lvl_b,
      n, m, dmin, dmax, out_idx, out_best, out_second);
  return (int)cudaGetLastError();
}
