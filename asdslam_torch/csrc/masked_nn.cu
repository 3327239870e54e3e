// Fused masked nearest-neighbour search for Hopper (sm_90a): spatially
// ordered, gate-culled tiles with the D-deep dot on the tensor cores, built
// for the two descriptor widths the system has: D = 128 (ASD) and D = 256
// (the ORB embedding).
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
// second == best); a row with no gated-in pair gives (0, BIG, BIG).
//
// What bounds it.  On the tracking path the windows admit ~0.1% (motion
// search, 2000 x 2000) and ~0.01% (local-map search, 8192 x 2000) of the
// pairs, so the work these inputs need is the bf16 dot of the gated-in
// pairs (well under a microsecond at 989 TFLOP/s) and the bytes of the
// descriptors (1-5 MB at D = 128, twice that at D = 256; one to three
// microseconds at 3.35 TB/s).  Launches and the ordering step set the time,
// not either bound.
//
// Design (three launches from one C call, no host synchronisation):
//  1. order_kernel, one block per side and problem: a counting sort of the
//     rows of A and the columns of B by the Morton code of their 32-px cell,
//     with entries that can never pass the gate (invalid, NaN position)
//     keyed last.  The binning uses shared-memory atomics (per entry; per
//     warp for the inert key, which may hold most entries), so the order
//     inside a cell may change from run to run; nothing below depends on it.
//  2. gather_kernel, one block per 64-entry tile and problem: the
//     descriptors in sorted order as bf16 (rounded once per call, as the TPU
//     wrapper does), the f32 norms of the unrounded values, each entry's
//     position, level and validity, and a summary per tile: the box of uv
//     (for rows, widened by the window radius and a margin for f32
//     rounding), the level range and the count of entries that can pass the
//     gate.
//  3. search_kernel, one warpgroup per (64-row tile, column split, problem):
//     skips every column tile whose summary cannot meet the row tile's (boxes
//     apart, levels out of window, or nothing valid), stages each live B
//     tile as bf16 into a two-stage cp.async ring in the 128-byte-swizzled
//     layout (D / 64 slabs of 64 columns), runs the dot as D / 16 wgmma
//     m64n64k16 (bf16 -> f32, A and B from shared memory), and folds the
//     tile into a running top-2 per row in registers.  The gate and distance
//     use non-contracting intrinsics, so they round as the plain PyTorch
//     version does; only the order of the D-term dot differs (~1e-6; none on
//     the ORB embedding, whose +-1/16 entries make every partial sum exact).
//     Columns are split across blocks (~4 blocks per multiprocessor; at
//     D = 256 a block takes ~101 KB of shared memory against ~54 KB at
//     D = 128, so at most two share an SM); the last block of a row tile to
//     finish merges its splits in split order and writes the rows back to
//     their original places.
// The running top-2 is ordered lexicographically by (d, original column
// index), so it does not depend on the order in which pairs are visited,
// and a culled tile (which holds no gated-in pair) needs no work: that is
// what makes the culling and the reordering exact.
//
// A batch of B independent problems of one shape (the reference's
// jax.vmap of the search, a leading grid axis of B) is one launch of the
// same three kernels: the last grid axis selects the problem b, whose
// inputs and outputs are the b-th slices of arrays with a leading B axis and
// whose scratch is the b-th of B consecutive blocks of one problem's layout.  A
// problem's blocks run the same arithmetic in the same order whatever B is,
// so its results are the same bits as its own launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;               // rows per row tile, columns per column tile
constexpr float CELL_SCALE = 1.f / 32.f;  // 32-px cells
constexpr int CELLS = 64;              // cells per axis (positions beyond clamp)
constexpr int NKEYS = CELLS * CELLS + 1;  // Morton keys, then the inert key
constexpr int INERT = NKEYS - 1;
constexpr int SORT_THREADS = 1024;
constexpr int KEY_CAP = 12288;         // sort keys kept in shared memory
constexpr int GATHER_THREADS = 256;
constexpr int SEARCH_THREADS = 128;    // one warpgroup
constexpr int SUMMARY = 8;             // floats per tile summary
constexpr float BIG = 1e30f;

// search_kernel shared memory: the A tile, then two stages of B tile +
// column info (float4 per column) + column index; tiles 1024-byte aligned.
constexpr int SLAB = TILE * 128;       // 64 rows x 64 bf16: one swizzle atom column
template <int D>
struct Smem {
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  static constexpr int TILE_BYTES = (D / 64) * SLAB;  // 64 x D bf16
  static constexpr int INFO_OFF = TILE_BYTES;
  static constexpr int CIDX_OFF = INFO_OFF + TILE * 16;
  // TILE_BYTES + 1024 + 256, rounded up to 1024
  static constexpr int STAGE_BYTES = (CIDX_OFF + TILE * 4 + 1023) / 1024 * 1024;
  static constexpr int BYTES = 1024 + TILE_BYTES + 2 * STAGE_BYTES;
};
static_assert(Smem<128>::BYTES == 54272 && Smem<256>::BYTES == 103424, "smem layout");

struct SideIn {
  const float* desc;       // [count, D]
  const float* uv;         // [count, 2]
  const float* rad2;       // [count] (rows) or null (columns)
  const uint8_t* valid;    // [count]
  const int32_t* lvl;      // [count]
  int count;
};

struct SideOut {
  int32_t* perm;           // [padded]: sorted position -> original index, -1 past the end
  __nv_bfloat16* d16;      // [padded, D]
  float4* info;            // [padded]: x, y, |desc|^2, level (int bits)
  float* rad2;             // [padded] (rows) or null
  int32_t* idx;            // [padded]: original index if valid, else -1
  float* summary;          // [padded / TILE, SUMMARY]
  int padded;
};

__device__ __forceinline__ bool can_pass(const SideIn& s, int e, float x, float y) {
  // an entry that can pass the exact gate with some partner
  return s.valid[e] != 0 && !isnan(x) && !isnan(y) && !(s.rad2 != nullptr && isnan(s.rad2[e]));
}

__device__ __forceinline__ uint32_t spread6(uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) r |= ((v >> b) & 1u) << (2 * b);
  return r;
}

__device__ __forceinline__ uint32_t cell_of(float v) {
  return (uint32_t)fminf(fmaxf(floorf(v * CELL_SCALE), 0.f), (float)(CELLS - 1));
}

__device__ __forceinline__ int sort_key(const SideIn& s, int e) {
  const float x = s.uv[2 * e], y = s.uv[2 * e + 1];
  if (!can_pass(s, e, x, y)) return INERT;
  return (int)(spread6(cell_of(x)) | (spread6(cell_of(y)) << 1));
}

// Problem `p` of a batch: the p-th slices of the inputs (D floats a
// descriptor), and a pointer moved `bytes` on, into the p-th scratch block.
__device__ __forceinline__ SideIn problem_in(SideIn s, int p, int D) {
  const size_t e = (size_t)p * s.count;
  s.desc += e * D;
  s.uv += e * 2;
  if (s.rad2 != nullptr) s.rad2 += e;
  s.valid += e;
  s.lvl += e;
  return s;
}

template <typename T>
__device__ __forceinline__ T* shifted(T* ptr, long long bytes) {
  return ptr == nullptr ? ptr : (T*)((const char*)ptr + bytes);
}

__device__ __forceinline__ SideOut problem_out(SideOut o, long long bytes) {
  o.perm = shifted(o.perm, bytes);
  o.d16 = shifted(o.d16, bytes);
  o.info = shifted(o.info, bytes);
  o.rad2 = shifted(o.rad2, bytes);
  o.idx = shifted(o.idx, bytes);
  o.summary = shifted(o.summary, bytes);
  return o;
}

// 1. Counting sort by cell key, one block per side (grid x) and problem
// (grid y).  The keys of the first KEY_CAP entries are computed once (their
// loads issued together) and kept in shared memory; any further ones are
// recomputed where they are needed.
__global__ void __launch_bounds__(SORT_THREADS)
order_kernel(SideIn a, SideIn b, int32_t* perm_a, int np_, int32_t* perm_b, int mp,
             int* done, long long block) {
  __shared__ int hist[NKEYS];
  __shared__ int wsum[SORT_THREADS / 32];
  __shared__ uint16_t keys[KEY_CAP];
  const int prob = blockIdx.y;
  const long long shift = prob * block;
  // only the positions are read here: the descriptor stride does not matter
  const SideIn s = problem_in(blockIdx.x == 0 ? a : b, prob, 0);
  int32_t* perm = shifted(blockIdx.x == 0 ? perm_a : perm_b, shift);
  done = shifted(done, shift);
  const int padded = blockIdx.x == 0 ? np_ : mp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cached = min(s.count, KEY_CAP);

  for (int k = tid; k < NKEYS; k += SORT_THREADS) hist[k] = 0;
#pragma unroll 4
  for (int e = tid; e < cached; e += SORT_THREADS) keys[e] = (uint16_t)sort_key(s, e);
  __syncthreads();
  // cells hold a few entries each: one atomic per entry; the inert key,
  // which may hold most of them, one per warp
  for (int base = 0; base < s.count; base += SORT_THREADS) {
    const int e = base + tid;
    const int key = e < s.count ? (e < KEY_CAP ? keys[e] : sort_key(s, e)) : -1;
    const unsigned inert = __ballot_sync(0xffffffffu, key == INERT);
    if (key >= 0 && key != INERT) atomicAdd(&hist[key], 1);
    if (lane == 0 && inert) atomicAdd(&hist[INERT], __popc(inert));
  }
  __syncthreads();
  // exclusive scan of hist: each thread owns PER consecutive keys
  constexpr int PER = (NKEYS + SORT_THREADS - 1) / SORT_THREADS;
  int local[PER];
  int sum = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int k = tid * PER + q;
    local[q] = k < NKEYS ? hist[k] : 0;
    sum += local[q];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = wsum[lane];
    int vi = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, vi, off);
      if (lane >= off) vi += t;
    }
    wsum[lane] = vi - v;
  }
  __syncthreads();
  int run = wsum[warp] + incl - sum;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int k = tid * PER + q;
    if (k < NKEYS) hist[k] = run;
    run += local[q];
  }
  __syncthreads();

  // scatter, the inert entries ranked by lane within their warp
  for (int base = 0; base < s.count; base += SORT_THREADS) {
    const int e = base + tid;
    const int key = e < s.count ? (e < KEY_CAP ? keys[e] : sort_key(s, e)) : -1;
    const unsigned inert = __ballot_sync(0xffffffffu, key == INERT);
    int first = 0;
    if (lane == 0 && inert) first = atomicAdd(&hist[INERT], __popc(inert));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (key == INERT) perm[first + __popc(inert & ((1u << lane) - 1u))] = e;
    else if (key >= 0) perm[atomicAdd(&hist[key], 1)] = e;
  }
  for (int p = s.count + tid; p < padded; p += SORT_THREADS) perm[p] = -1;
  // the search kernel's per-row-tile completion counters start at zero
  if (blockIdx.x == 0)
    for (int t = tid; t < padded / TILE; t += SORT_THREADS) done[t] = 0;
}

// The box of x +- (sqrt(rad2) + margin), y likewise: every column that the
// exact f32 gate admits lies inside it.  The gate passing implies
// |x_a - x_b| <= sqrt(rad2) (1 + 3e-7); the margin of 1 px plus 1e-6 of the
// magnitudes covers that and the rounding of the box itself.  A non-finite
// position or radius gives the whole plane.
__device__ __forceinline__ float4 row_box(float x, float y, float r2) {
  const float r = __fsqrt_rn(fmaxf(r2, 0.f));
  if (!(isfinite(x) && isfinite(y) && isfinite(r)))
    return make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  const float mx = __fadd_rn(1.f, __fmul_rn(1e-6f, __fadd_rn(fabsf(x), r)));
  const float my = __fadd_rn(1.f, __fmul_rn(1e-6f, __fadd_rn(fabsf(y), r)));
  return make_float4(__fsub_rn(__fsub_rn(x, r), mx), __fadd_rn(__fadd_rn(x, r), mx),
                     __fsub_rn(__fsub_rn(y, r), my), __fadd_rn(__fadd_rn(y, r), my));
}

// 2. Sorted bf16 descriptors, entry info and tile summaries; one block per
// 64-entry tile (grid x, row tiles first) and problem (grid y).  Lane l of a
// warp holds float4s l, l + 32, ... of each of its entries' rows (D / 128 of
// them).
template <int D>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(SideIn a, SideOut oa, SideIn b, SideOut ob, long long block) {
  __shared__ float4 ebox[TILE];
  __shared__ int elvl[TILE];
  __shared__ int epass[TILE];
  const int row_tiles = oa.padded / TILE;
  const bool rows = (int)blockIdx.x < row_tiles;
  const SideIn s = problem_in(rows ? a : b, blockIdx.y, D);
  const SideOut o = problem_out(rows ? oa : ob, blockIdx.y * block);
  const int tile = rows ? blockIdx.x : blockIdx.x - row_tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // warp w owns entries 8w .. 8w+7 of the tile; their loads are issued together
  constexpr int PER_WARP = TILE / (GATHER_THREADS / 32);
  constexpr int PER_LANE = D / 128;  // float4s of a row per lane
  const int p0 = tile * TILE + warp * PER_WARP;
  const int mine = lane < PER_WARP ? o.perm[p0 + lane] : -1;
  float4 v[PER_WARP][PER_LANE];
  float ss[PER_WARP];
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    const int e = __shfl_sync(0xffffffffu, mine, k);
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q)
      v[k][q] = e >= 0 ? __ldg(reinterpret_cast<const float4*>(s.desc) + (size_t)e * (D / 4) +
                               32 * q + lane)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < PER_WARP; ++k) {
    ss[k] = 0.f;
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const float4 x = v[k][q];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      reinterpret_cast<uint2*>(o.d16)[(size_t)(p0 + k) * (D / 4) + 32 * q + lane] = packed;
      ss[k] += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], off);
  }
  // lane k < 8 writes entry k's info
  float norm = ss[0];
#pragma unroll
  for (int k = 1; k < PER_WARP; ++k) norm = lane == k ? ss[k] : norm;
  if (lane < PER_WARP) {
    const int e = mine, r = warp * PER_WARP + lane, p = p0 + lane;
    float x = 0.f, y = 0.f, r2 = 0.f;
    int lv = 0;
    bool valid = false, pass = false;
    if (e >= 0) {
      x = s.uv[2 * e];
      y = s.uv[2 * e + 1];
      lv = s.lvl[e];
      valid = s.valid[e] != 0;
      if (rows) r2 = s.rad2[e];
      pass = can_pass(s, e, x, y);
    }
    o.info[p] = make_float4(x, y, norm, __int_as_float(lv));
    o.idx[p] = valid ? e : -1;
    if (rows) o.rad2[p] = r2;
    ebox[r] = rows ? row_box(x, y, r2) : make_float4(x, x, y, y);
    elvl[r] = lv;
    epass[r] = pass;
  }
  __syncthreads();
  if (warp == 0) {
    float4 box = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
    int lmin = 0x7fffffff, lmax = -0x7fffffff - 1, count = 0;
    for (int r = lane; r < TILE; r += 32) {
      if (!epass[r]) continue;
      box.x = fminf(box.x, ebox[r].x);
      box.y = fmaxf(box.y, ebox[r].y);
      box.z = fminf(box.z, ebox[r].z);
      box.w = fmaxf(box.w, ebox[r].w);
      lmin = min(lmin, elvl[r]);
      lmax = max(lmax, elvl[r]);
      ++count;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      box.x = fminf(box.x, __shfl_xor_sync(0xffffffffu, box.x, off));
      box.y = fmaxf(box.y, __shfl_xor_sync(0xffffffffu, box.y, off));
      box.z = fminf(box.z, __shfl_xor_sync(0xffffffffu, box.z, off));
      box.w = fmaxf(box.w, __shfl_xor_sync(0xffffffffu, box.w, off));
      lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, off));
      lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
      count += __shfl_xor_sync(0xffffffffu, count, off);
    }
    if (lane == 0) {
      float* out = o.summary + tile * SUMMARY;
      out[0] = box.x;
      out[1] = box.y;
      out[2] = box.z;
      out[3] = box.w;
      out[4] = __int_as_float(lmin);
      out[5] = __int_as_float(lmax);
      out[6] = __int_as_float(count);
      out[7] = 0.f;
    }
  }
}

// Can any row of the row tile pass the gate with any column of the column
// tile?  Conservative: false only when the boxes miss, the level ranges
// cannot meet within [dmin, dmax], or either side has nothing that can pass.
__device__ __forceinline__ bool tiles_meet(const float* r, const float* c, float dmin, float dmax) {
  if (__float_as_int(r[6]) == 0 || __float_as_int(c[6]) == 0) return false;
  if (!(r[0] <= c[1] && c[0] <= r[1] && r[2] <= c[3] && c[2] <= r[3])) return false;
  const float hi = (float)(__float_as_int(c[5]) - __float_as_int(r[4]));
  const float lo = (float)(__float_as_int(c[4]) - __float_as_int(r[5]));
  return hi >= dmin && lo <= dmax;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}

// A 64 x D bf16 tile (rows of 2D bytes in global memory, D / 8 chunks of 16
// bytes) into the K-major 128-byte-swizzled layout: D / 64 slabs of 64 rows x
// 128 B (k 0-63, k 64-127, ...); the 16-byte chunk c of row r sits in slab
// c / 8, at chunk (c % 8) ^ (r % 8) of its row.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int tid) {
  constexpr int CHUNKS = D / 8;
  const char* g = reinterpret_cast<const char*>(src);
#pragma unroll
  for (int e = tid; e < TILE * CHUNKS; e += SEARCH_THREADS) {
    const int r = e / CHUNKS, c = e % CHUNKS;
    cp_async16(dst + (c >> 3) * SLAB + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               g + r * (2 * D) + c * 16);
  }
}

template <int D>
__device__ __forceinline__ void load_stage(uint32_t stage, const __nv_bfloat16* b16,
                                           const float4* binfo, const int32_t* bidx, int ct, int tid) {
  load_tile<D>(stage, b16 + (size_t)ct * TILE * D, tid);
  if (tid < TILE) cp_async16(stage + Smem<D>::INFO_OFF + tid * 16, binfo + ct * TILE + tid);
  else if (tid < TILE + TILE / 4) cp_async16(stage + Smem<D>::CIDX_OFF + (tid - TILE) * 16,
                                             bidx + ct * TILE + (tid - TILE) * 4);
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 B apart (SBO 64 x 16 B), LBO 1 (unused with this swizzle).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, bf16 in, f32 accumulate.
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and
// columns 8 c + 2 (t % 4) (+ 1): d[4c + 2h + e] is (row + 8h, column + e).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Take (d, j) into the running (best, idx, second), ordered by (d, j).
__device__ __forceinline__ void take(float& b, int& i, float& s, float d, int j) {
  if (d < b || (d == b && j < i)) {
    s = b;
    b = d;
    i = j;
  } else {
    s = fminf(s, d);
  }
}

// Merge the top-2 of a disjoint set of columns, by the same order.
__device__ __forceinline__ void merge(float& b, int& i, float& s, float b2, int i2, float s2) {
  const bool win = b2 < b || (b2 == b && i2 < i);
  s = fminf(fminf(s, s2), win ? b : b2);
  if (win) {
    b = b2;
    i = i2;
  }
}

// One live B tile: wait for its stage, the dot on the tensor cores, the
// gate and the running top-2 of the thread's two rows.
struct RowState {
  float x[2], y[2], a2[2], r2[2];
  int lvl[2];
  bool valid[2];
  float best[2], second[2];
  int idx[2];
};

template <int D>
__device__ __forceinline__ void search_tile(RowState& st, uint32_t sa, uint32_t sb,
                                            const uint8_t* stage_ptr, int quad,
                                            float dmin, float dmax) {
  float acc[32] = {};
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    const uint32_t off = (kt >> 2) * SLAB + (kt & 3) * 32;
    wgmma_m64n64k16(acc, smem_desc(sa + off), smem_desc(sb + off), kt > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);

  const float4* cinfo = reinterpret_cast<const float4*>(stage_ptr + Smem<D>::INFO_OFF);
  const int* cidx = reinterpret_cast<const int*>(stage_ptr + Smem<D>::CIDX_OFF);
#pragma unroll
  for (int c = 0; c < TILE / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * c + 2 * quad + e;
      const int j = cidx[col];
      const float4 ci = cinfo[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dx = __fsub_rn(st.x[h], ci.x);
        const float dy = __fsub_rn(st.y[h], ci.y);
        const float ld = (float)(__float_as_int(ci.w) - st.lvl[h]);
        const bool ok = st.valid[h] && j >= 0 &&
                        __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= st.r2[h] &&
                        ld >= dmin && ld <= dmax;
        if (ok) {
          const float dd = __fsub_rn(__fadd_rn(st.a2[h], ci.z), __fmul_rn(2.f, acc[4 * c + 2 * h + e]));
          take(st.best[h], st.idx[h], st.second[h], fmaxf(dd, 0.f), j);
        }
      }
    }
  }
}

// 3. The culled search: one warpgroup per (row tile, column split) of a
// problem (grid z).  The split's column tiles are tested against the row
// tile 128 at a time, all threads at once, into a list of live tiles in
// shared memory; the block then walks the list with the next tile's copy in
// flight.
template <int D>
__global__ void __launch_bounds__(SEARCH_THREADS)
search_kernel(const __nv_bfloat16* __restrict__ a16, const float4* __restrict__ ainfo,
              const float* __restrict__ arad, const int32_t* __restrict__ aidx,
              const float* __restrict__ rsum,
              const __nv_bfloat16* __restrict__ b16, const float4* __restrict__ binfo,
              const int32_t* __restrict__ bidx, const float* __restrict__ csum,
              int col_tiles, int np_, float dmin, float dmax,
              float* __restrict__ pbest, int32_t* __restrict__ pidx, float* __restrict__ psec,
              int* __restrict__ done, const int32_t* __restrict__ perm_a,
              int32_t* __restrict__ out_idx, float* __restrict__ out_best,
              float* __restrict__ out_second, long long block, int n) {
  constexpr int TILE_BYTES = Smem<D>::TILE_BYTES, STAGE_BYTES = Smem<D>::STAGE_BYTES;
  {  // problem blockIdx.z: its scratch block and its rows of the outputs
    const long long shift = blockIdx.z * block;
    a16 = shifted(a16, shift);
    ainfo = shifted(ainfo, shift);
    arad = shifted(arad, shift);
    aidx = shifted(aidx, shift);
    rsum = shifted(rsum, shift);
    b16 = shifted(b16, shift);
    binfo = shifted(binfo, shift);
    bidx = shifted(bidx, shift);
    csum = shifted(csum, shift);
    pbest = shifted(pbest, shift);
    pidx = shifted(pidx, shift);
    psec = shifted(psec, shift);
    done = shifted(done, shift);
    perm_a = shifted(perm_a, shift);
    const size_t rows = (size_t)blockIdx.z * n;
    out_idx += rows;
    out_best += rows;
    out_second += rows;
  }
  extern __shared__ uint8_t smem_raw[];
  __shared__ int live[SEARCH_THREADS];
  __shared__ int warp_live[SEARCH_THREADS / 32];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sa = base;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int rt = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int c_begin = split * col_tiles / splits, c_end = (split + 1) * col_tiles / splits;
  float rs[SUMMARY];
#pragma unroll
  for (int k = 0; k < SUMMARY; ++k) rs[k] = rsum[rt * SUMMARY + k];
  const int row0 = rt * TILE + warp * 16 + (lane >> 2);

  RowState st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.best[h] = BIG;
    st.second[h] = BIG;
    st.idx[h] = 0;
  }
  bool a_loaded = false;
  int stage = 0;
  for (int chunk = c_begin; chunk < c_end; chunk += SEARCH_THREADS) {
    const int c = chunk + tid;
    const bool is_live = c < c_end && tiles_meet(rs, csum + c * SUMMARY, dmin, dmax);
    const unsigned ballot = __ballot_sync(0xffffffffu, is_live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < SEARCH_THREADS / 32; ++w) {
      before += w < warp ? warp_live[w] : 0;
      total += warp_live[w];
    }
    if (is_live) live[before + __popc(ballot & ((1u << lane) - 1u))] = c;
    __syncthreads();
    if (total == 0) continue;

    if (!a_loaded) {
      load_tile<D>(sa, a16 + (size_t)rt * TILE * D, tid);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = row0 + 8 * h;
        const float4 inf = ainfo[p];
        st.x[h] = inf.x;
        st.y[h] = inf.y;
        st.a2[h] = inf.z;
        st.lvl[h] = __float_as_int(inf.w);
        st.r2[h] = arad[p];
        st.valid[h] = aidx[p] >= 0;
      }
      a_loaded = true;
    }
    load_stage<D>(base + TILE_BYTES + stage * STAGE_BYTES, b16, binfo, bidx, live[0], tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int q = 0; q < total; ++q) {
      if (q + 1 < total) {
        load_stage<D>(base + TILE_BYTES + (stage ^ 1) * STAGE_BYTES, b16, binfo, bidx,
                      live[q + 1], tid);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      // cp.async wrote through the generic proxy; wgmma reads through the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      search_tile<D>(st, sa, base + TILE_BYTES + stage * STAGE_BYTES,
                  gbase + TILE_BYTES + stage * STAGE_BYTES, quad, dmin, dmax);
      __syncthreads();  // this stage is refilled two tiles on
      stage ^= 1;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, st.best[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, st.idx[h], off);
      const float os = __shfl_xor_sync(0xffffffffu, st.second[h], off);
      merge(st.best[h], st.idx[h], st.second[h], ob, oi, os);
    }
    if (quad == 0) {
      const size_t p = (size_t)split * np_ + row0 + 8 * h;
      pbest[p] = st.best[h];
      pidx[p] = st.idx[h];
      psec[p] = st.second[h];
    }
  }

  // The last block of this row tile to finish merges the splits in split
  // order and writes the rows to their original places.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&done[rt], 1) == splits - 1;
  __syncthreads();
  if (!last || tid >= TILE) return;
  __threadfence();
  const int p = rt * TILE + tid;
  const int row = perm_a[p];
  if (row < 0) return;
  float b = __ldcg(pbest + p), sec = __ldcg(psec + p);
  int i = __ldcg(pidx + p);
  for (int sp = 1; sp < splits; ++sp) {
    const size_t q = (size_t)sp * np_ + p;
    merge(b, i, sec, __ldcg(pbest + q), __ldcg(pidx + q), __ldcg(psec + q));
  }
  out_idx[row] = i;
  out_best[row] = b;
  out_second[row] = sec;
}

// Scratch fields, in order; each starts 256-byte aligned.
enum Field { PERM_A, PERM_B, A16, B16, AINFO, BINFO, ARAD, AIDX, BIDX, RSUM, CSUM,
             PBEST, PIDX, PSEC, DONE, N_FIELDS };

// Column splits: enough (row tile, split) blocks for ~4 per multiprocessor
// of an H100 SXM (132), at most one split per column tile.
int split_count(int np_, int mp) {
  return max(1, min(mp / TILE, 4 * 132 / (np_ / TILE)));
}

long long scratch_layout(int n, int m, int d, long long* off) {
  const long long np_ = (n + TILE - 1) / TILE * TILE, mp = (m + TILE - 1) / TILE * TILE;
  const long long splits = split_count((int)np_, (int)mp);
  const long long bytes[N_FIELDS] = {
      4 * np_, 4 * mp, 2 * np_ * d, 2 * mp * d, 16 * np_, 16 * mp, 4 * np_, 4 * np_, 4 * mp,
      4 * SUMMARY * np_ / TILE, 4 * SUMMARY * mp / TILE, 4 * splits * np_, 4 * splits * np_,
      4 * splits * np_, 4 * np_ / TILE};
  long long o = 0;
  for (int f = 0; f < N_FIELDS; ++f) {
    off[f] = o;
    o = (o + bytes[f] + 255) / 256 * 256;
  }
  return o;
}

// One launch of the three kernels at width D over `batch` problems; returns
// the first cudaError_t.
template <int D>
int launch(const float* desc_a, const float* desc_b, const uint8_t* valid_a,
           const uint8_t* valid_b, const float* uv_a, const float* uv_b, const float* rad2,
           const int32_t* lvl_a, const int32_t* lvl_b, int n, int m, int batch, float dmin,
           float dmax, void* scratch, int32_t* out_idx, float* out_best, float* out_second,
           cudaStream_t st) {
  // each instantiation of search_kernel needs its own opt-in above 48 KB
  static bool smem_attr_set = false;  // once per process and width
  if (!smem_attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        search_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_attr_set = true;
  }
  long long off[N_FIELDS];
  const long long block = scratch_layout(n, m, D, off);  // bytes of one problem's scratch
  char* b = static_cast<char*>(scratch);
  int32_t* perm_a = reinterpret_cast<int32_t*>(b + off[PERM_A]);
  int32_t* perm_b = reinterpret_cast<int32_t*>(b + off[PERM_B]);
  __nv_bfloat16* a16 = reinterpret_cast<__nv_bfloat16*>(b + off[A16]);
  __nv_bfloat16* b16 = reinterpret_cast<__nv_bfloat16*>(b + off[B16]);
  float4* ainfo = reinterpret_cast<float4*>(b + off[AINFO]);
  float4* binfo = reinterpret_cast<float4*>(b + off[BINFO]);
  float* arad = reinterpret_cast<float*>(b + off[ARAD]);
  int32_t* aidx = reinterpret_cast<int32_t*>(b + off[AIDX]);
  int32_t* bidx = reinterpret_cast<int32_t*>(b + off[BIDX]);
  float* rsum = reinterpret_cast<float*>(b + off[RSUM]);
  float* csum = reinterpret_cast<float*>(b + off[CSUM]);
  float* pbest = reinterpret_cast<float*>(b + off[PBEST]);
  int32_t* pidx = reinterpret_cast<int32_t*>(b + off[PIDX]);
  float* psec = reinterpret_cast<float*>(b + off[PSEC]);
  int* done = reinterpret_cast<int*>(b + off[DONE]);

  const int np_ = (n + TILE - 1) / TILE * TILE, mp = (m + TILE - 1) / TILE * TILE;
  const int splits = split_count(np_, mp);
  const SideIn ia{desc_a, uv_a, rad2, valid_a, lvl_a, n};
  const SideIn ib{desc_b, uv_b, nullptr, valid_b, lvl_b, m};
  const SideOut oa{perm_a, a16, ainfo, arad, aidx, rsum, np_};
  const SideOut ob{perm_b, b16, binfo, nullptr, bidx, csum, mp};

  order_kernel<<<dim3(2, batch), SORT_THREADS, 0, st>>>(ia, ib, perm_a, np_, perm_b, mp, done,
                                                        block);
  gather_kernel<D><<<dim3(np_ / TILE + mp / TILE, batch), GATHER_THREADS, 0, st>>>(
      ia, oa, ib, ob, block);
  search_kernel<D><<<dim3(np_ / TILE, splits, batch), SEARCH_THREADS, Smem<D>::BYTES, st>>>(
      a16, ainfo, arad, aidx, rsum, b16, binfo, bidx, csum, mp / TILE, np_, dmin, dmax,
      pbest, pidx, psec, done, perm_a, out_idx, out_best, out_second, block, n);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch buffer masked_nn_launch needs for `batch` problems of n rows
// and m columns of width d: its size in bytes (`batch` consecutive blocks of
// one problem's layout, each a multiple of 256 bytes); `offsets` (N_FIELDS =
// 15 entries) receives each field's byte offset in a block: perm_a [np_],
// perm_b [mp] int32 (np_, mp: n, m rounded up to 64); a16 [np_, d], b16
// [mp, d] bf16; ainfo [np_, 4], binfo [mp, 4] f32 (x, y, norm, level bits);
// arad [np_] f32; aidx [np_], bidx [mp] int32; rsum [np_/64, 8], csum
// [mp/64, 8] f32 (box, level range and count bits); pbest, pidx, psec
// [splits, np_]; done [np_/64] int32; and `splits` the column splits.
extern "C" long long masked_nn_scratch_layout(int n, int m, int d, int batch,
                                               long long* offsets, int* splits) {
  const int np_ = (n + TILE - 1) / TILE * TILE, mp = (m + TILE - 1) / TILE * TILE;
  *splits = split_count(np_, mp);
  return batch * scratch_layout(n, m, d, offsets);
}

// Plain C entry point (loaded with ctypes), its arguments in the order of
// the wrapper's.  Every pointer is a device pointer to a contiguous array
// with a leading axis of `batch` problems: desc_a [batch, n, d], desc_b
// [batch, m, d] f32 with d 128 or 256; valid_a [batch, n], valid_b [batch,
// m] bool (one byte); uv_a [batch, n, 2], uv_b [batch, m, 2], rad2 [batch,
// n] f32; lvl_a [batch, n], lvl_b [batch, m] int32; `scratch` as
// masked_nn_scratch_layout describes it for the same n, m, d and batch
// (256-byte aligned); outputs out_idx [batch, n] int32, out_best [batch,
// n], out_second [batch, n] f32.  Launches on `stream` without
// synchronising; returns the first cudaError_t (cudaErrorInvalidValue for
// another width, or for an empty or too large a batch).
extern "C" int masked_nn_launch(
    const float* desc_a, const float* desc_b, const uint8_t* valid_a, const uint8_t* valid_b,
    const float* uv_a, const float* uv_b, const float* rad2,
    const int32_t* lvl_a, const int32_t* lvl_b, int n, int m, int d, int batch, float dmin,
    float dmax, void* scratch, int32_t* out_idx, float* out_best, float* out_second,
    void* stream) {
  if (n <= 0 || m <= 0 || batch <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 128)
    return launch<128>(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, lvl_a, lvl_b, n, m,
                       batch, dmin, dmax, scratch, out_idx, out_best, out_second, st);
  if (d == 256)
    return launch<256>(desc_a, desc_b, valid_a, valid_b, uv_a, uv_b, rad2, lvl_a, lvl_b, n, m,
                       batch, dmin, dmax, scratch, out_idx, out_best, out_second, st);
  return (int)cudaErrorInvalidValue;
}
