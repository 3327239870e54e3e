// One Levenberg-Marquardt iteration of motion-only bundle adjustment, and
// the chi2 gate between its rounds, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this loop as a lax.scan
// under jit (asdslam_tpu/backend/ba.py::pose_only_optimize), which XLA fuses
// into a few programs.  Run as plain PyTorch, each iteration was hundreds
// of tiny kernels; this source makes it one launch.  The solver's schedule
// (rounds, iterations, Huber in every round but the last, the reset of the
// damping) stays in Python, in backend/ba.py::pose_only_optimize, which
// calls the two entry points below through ops/pose_lm.py.
//
// pose_lm_step, one problem (a camera pose against N fixed points):
//   r_o   = project(R X_o + t) - uv_o      (depth clamped to 1e-6 where
//                                           |z| < 1e-6), J_o its Jacobian
//                                           in the left-multiplicative
//                                           tangent (rotation first)
//   chi2_o = |r_o|^2 inv_sigma2_o
//   w_o   = inv_sigma2_o * huber_w(chi2_o) * inlier_o,
//           huber_w = 1 up to 5.991, sqrt(5.991) / sqrt(chi2) above it
//           (1 everywhere when use_huber is off)
//   H = sum_o w_o J_o^T J_o,  g = sum_o w_o J_o^T r_o
//   dx = chol_solve(H + lam diag(H) + 1e-9 I, g)   (pivots clamped to 1e-20)
//   cand = exp(-dx) * T
//   new_cost = sum over inliers of rho(chi2_o at cand), rho the Huber cost
//   accept iff new_cost < cost: T, cost <- cand, new_cost and lam * 0.33
//   (at least 1e-9); else lam * 4 (at most 1e6).
// pose_lm_gate: inlier_o = valid_o && chi2_o <= chi2_th && z_o > 0 (with
// gate off: inlier_o = valid_o), and the cost of the pose over those
// inliers, the next round's starting cost.
// Each step follows backend/ba.py's plain version term by term
// (_project_residuals, se3.se3_exp / compose / matrix_to_quat,
// linalg.chol_solve_small), in float32; only the order of the sums differs.
//
// What bounds it.  A step reads 25 bytes a row in each of its two passes
// (N = 2,000: 100 KB, which L2 holds from one launch to the next) and does
// ~250 flops a row: well under a microsecond at 3.35 TB/s or 67 TFLOP/s.
// Its time is a chain of dependent steps: the row pass, a block reduction
// of 27 sums, the serial 6x6 solve and retraction, the trial-cost pass and
// a second reduction (14 us a step at N = 2,000 on an H100).
//
// Design: one block of 256 threads a problem; the grid's x axis runs over a
// batch of problems with the same N (the vmapped multi-sequence step), each
// block doing what the unbatched launch does.  Thread i takes rows i,
// i + 256, ... and sums H's 21 upper-triangle entries and g's 6 in
// registers; warps reduce by shuffles, then the warps' partials are summed
// in warp order in shared memory: a fixed order and no atomics, so a
// result is the same bits from run to run and in any batch.  Every thread
// then solves the 6x6 system and retracts the pose itself (the same bits in
// each thread), which saves a round trip through shared memory; one thread
// writes the state (pose, lam, cost) back.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;  // H's upper triangle (21), then g (6)
constexpr float kDelta2 = 5.991f;  // the Huber threshold on chi2 (CHI2_MONO)

struct Camera {
  float R[9], t[3];
};

struct Intrinsics {
  float fx, fy, cx, cy;
};

// se3.pose_unpack: the rotation of the normalised quaternion (w, x, y, z).
__device__ __forceinline__ Camera unpack(const float* p) {
  float n = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + p[3] * p[3]);
  n = n < 1e-8f ? 1e-8f : n;
  const float w = p[0] / n, x = p[1] / n, y = p[2] / n, z = p[3] / n;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  Camera c;
  c.R[0] = 1.f - 2.f * (yy + zz); c.R[1] = 2.f * (xy - wz); c.R[2] = 2.f * (xz + wy);
  c.R[3] = 2.f * (xy + wz); c.R[4] = 1.f - 2.f * (xx + zz); c.R[5] = 2.f * (yz - wx);
  c.R[6] = 2.f * (xz - wy); c.R[7] = 2.f * (yz + wx); c.R[8] = 1.f - 2.f * (xx + yy);
  c.t[0] = p[4]; c.t[1] = p[5]; c.t[2] = p[6];
  return c;
}

// One observation: camera-frame point, clamped depth, residual, chi2.
struct Row {
  float x, y, z, zs, r0, r1, chi2;
};

__device__ __forceinline__ Row project(const Camera& c, const Intrinsics& k,
                                       const float* X, const float* uv, float inv_s2) {
  Row o;
  o.x = c.R[0] * X[0] + c.R[1] * X[1] + c.R[2] * X[2] + c.t[0];
  o.y = c.R[3] * X[0] + c.R[4] * X[1] + c.R[5] * X[2] + c.t[1];
  o.z = c.R[6] * X[0] + c.R[7] * X[1] + c.R[8] * X[2] + c.t[2];
  o.zs = fabsf(o.z) < 1e-6f ? 1e-6f : o.z;
  o.r0 = (k.fx * o.x / o.zs + k.cx) - uv[0];
  o.r1 = (k.fy * o.y / o.zs + k.cy) - uv[1];
  o.chi2 = (o.r0 * o.r0 + o.r1 * o.r1) * inv_s2;
  return o;
}

// The Huber cost rho(chi2) of the plain version's cost_fn.
__device__ __forceinline__ float huber_cost(float chi2) {
  return chi2 <= kDelta2 ? chi2 : 2.f * sqrtf(kDelta2 * fmaxf(chi2, 1e-12f)) - kDelta2;
}

// The block's sum of v[0..n), the same in every thread: shuffles within
// each warp, then the warps' partials in warp order.  `part` holds
// kWarps * n floats, `total` n floats.
template <int n>
__device__ __forceinline__ void block_sum(float (&v)[n], float* part, float* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < n; ++i) part[warp * n + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float s = part[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += part[w * n + threadIdx.x];
    total[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = total[i];
}

// The Huber cost of `pose` summed over the rows whose mask is set, by the
// whole block (every thread returns it).
__device__ float masked_cost(const Camera& c, const Intrinsics& k, const float* points,
                             const float* uv, const float* inv_s2, const bool* mask, int n,
                             float* part, float* total) {
  float acc[1] = {0.f};
  for (int o = threadIdx.x; o < n; o += kThreads) {
    const Row r = project(c, k, points + 3 * o, uv + 2 * o, inv_s2[o]);
    acc[0] += mask[o] ? huber_cost(r.chi2) : 0.f;
  }
  block_sum(acc, part, total);
  return acc[0];
}

// linalg.chol_solve_small on the lower triangle of A (6x6 SPD), pivots
// clamped to 1e-20: x with A x = b.
__device__ __forceinline__ void chol_solve6(const float (&A)[6][6], const float (&b)[6],
                                            float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < j; ++q) s += L[i][q] * L[j][q];
      s = A[i][j] - s;
      L[i][j] = i == j ? sqrtf(fmaxf(s, 1e-20f)) : s / L[j][j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < i; ++q) s += L[i][q] * y[q];
    y[i] = (b[i] - s) / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = 0.f;
#pragma unroll
    for (int q = i + 1; q < 6; ++q) s += L[q][i] * x[q];
    x[i] = (y[i] - s) / L[i][i];
  }
}

// 3x3 products, row-major.
__device__ __forceinline__ void matmul3(const float* a, const float* b, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
  }
}

// se3.pose_retract: the packed pose of exp(xi) * T (se3.se3_exp with its
// small-angle branch, se3.compose, se3.matrix_to_quat).
__device__ void retract(const Camera& c, const float (&xi)[6], float* out) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-8f;
  const float a = small ? 1.f - theta2 / 6.f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta)) / theta2;
  const float cc = small ? 1.f / 6.f - theta2 / 120.f : (1.f - a) / theta2;
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float WW[9], dR[9], V[9];
  matmul3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.f : 0.f;
    dR[i] = eye + a * W[i] + b * WW[i];
    V[i] = eye + b * W[i] + cc * WW[i];
  }
  float dt[3], Rn[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) dt[i] = V[3 * i] * xi[3] + V[3 * i + 1] * xi[4] + V[3 * i + 2] * xi[5];
  matmul3(dR, c.R, Rn);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[4 + i] = dR[3 * i] * c.t[0] + dR[3 * i + 1] * c.t[1] + dR[3 * i + 2] * c.t[2] + dt[i];

  // matrix_to_quat: the candidate of the largest pivot (first on ties),
  // w made non-negative, normalised
  const float m00 = Rn[0], m01 = Rn[1], m02 = Rn[2];
  const float m10 = Rn[3], m11 = Rn[4], m12 = Rn[5];
  const float m20 = Rn[6], m21 = Rn[7], m22 = Rn[8];
  const float tr = m00 + m11 + m22;
  const float piv[4] = {1.f + tr, 1.f + m00 - m11 - m22, 1.f - m00 + m11 - m22,
                        1.f - m00 - m11 + m22};
  int best = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (piv[i] > piv[best]) best = i;
  float q[4];
  if (best == 0) {
    q[0] = 1.f + tr; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (best == 1) {
    q[0] = m21 - m12; q[1] = 1.f + m00 - m11 - m22; q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (best == 2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = 1.f - m00 + m11 - m22; q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = 1.f - m00 - m11 + m22;
  }
  if (q[0] < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
  float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  n = n < 1e-8f ? 1e-8f : n;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = q[i] / n;
}

__global__ void __launch_bounds__(kThreads)
pose_lm_step_kernel(const float* __restrict__ pose, const float* __restrict__ lam,
                    const float* __restrict__ cost, const float* __restrict__ points,
                    const float* __restrict__ uv, const float* __restrict__ inv_s2,
                    const bool* __restrict__ inliers, const float* __restrict__ K, int n,
                    int use_huber, float* __restrict__ pose_out, float* __restrict__ lam_out,
                    float* __restrict__ cost_out) {
  __shared__ float part[kWarps * kSums];
  __shared__ float total[kSums];
  const int p = blockIdx.x;  // the problem
  pose += 7 * p; points += 3 * (size_t)n * p; uv += 2 * (size_t)n * p;
  inv_s2 += (size_t)n * p; inliers += (size_t)n * p; K += 9 * p;
  const Intrinsics k{K[0], K[4], K[2], K[5]};
  const Camera c = unpack(pose);

  // pass 1: the normal equations, summed in registers
  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
  for (int o = threadIdx.x; o < n; o += kThreads) {
    const float is2 = inv_s2[o];
    const Row r = project(c, k, points + 3 * o, uv + 2 * o, is2);
    const float zi = 1.f / r.zs;
    const float a0 = k.fx * zi, a2 = -k.fx * r.x * zi * zi;
    const float b1 = k.fy * zi, b2 = -k.fy * r.y * zi * zi;
    const float J0[6] = {a2 * r.y, a0 * r.z - a2 * r.x, -a0 * r.y, a0, 0.f, a2};
    const float J1[6] = {-b1 * r.z + b2 * r.y, -b2 * r.x, b1 * r.x, 0.f, b1, b2};
    float wh = 1.f;
    if (use_huber && !(r.chi2 <= kDelta2)) wh = sqrtf(kDelta2) / sqrtf(fmaxf(r.chi2, 1e-12f));
    const float w = is2 * wh * (inliers[o] ? 1.f : 0.f);
    int e = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float u0 = w * J0[i], u1 = w * J1[i];
#pragma unroll
      for (int j = i; j < 6; ++j) acc[e++] += u0 * J0[j] + u1 * J1[j];
      acc[21 + i] += u0 * r.r0 + u1 * r.r1;
    }
  }
  block_sum(acc, part, total);

  // the damped solve and the candidate, in every thread
  const float lam0 = lam[p];
  float A[6][6], g[6], dx[6], xi[6], cand[7];
  {
    int e = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j, ++e) A[j][i] = acc[e];
      A[i][i] = (A[i][i] + lam0 * A[i][i]) + 1e-9f;
      g[i] = acc[21 + i];
    }
  }
  chol_solve6(A, g, dx);
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = -dx[i];
  retract(c, xi, cand);

  // pass 2: the candidate's cost over the inliers
  const Camera cc = unpack(cand);
  const float new_cost = masked_cost(cc, k, points, uv, inv_s2, inliers, n, part, total);

  if (threadIdx.x == 0) {
    const float old = cost[p];
    const bool accept = new_cost < old;
#pragma unroll
    for (int i = 0; i < 7; ++i) pose_out[7 * p + i] = accept ? cand[i] : pose[i];
    lam_out[p] = accept ? fmaxf(lam0 * 0.33f, 1e-9f) : fminf(lam0 * 4.f, 1e6f);
    cost_out[p] = accept ? new_cost : old;
  }
}

__global__ void __launch_bounds__(kThreads)
pose_lm_gate_kernel(const float* __restrict__ pose, const float* __restrict__ points,
                    const float* __restrict__ uv, const float* __restrict__ inv_s2,
                    const bool* __restrict__ valid, const float* __restrict__ K, int n,
                    float chi2_th, int gate, bool* __restrict__ inliers_out,
                    float* __restrict__ cost_out) {
  __shared__ float part[kWarps];
  __shared__ float total[1];
  const int p = blockIdx.x;
  pose += 7 * p; points += 3 * (size_t)n * p; uv += 2 * (size_t)n * p;
  inv_s2 += (size_t)n * p; valid += (size_t)n * p; K += 9 * p;
  inliers_out += (size_t)n * p;
  const Intrinsics k{K[0], K[4], K[2], K[5]};
  const Camera c = unpack(pose);
  float acc[1] = {0.f};
  for (int o = threadIdx.x; o < n; o += kThreads) {
    const Row r = project(c, k, points + 3 * o, uv + 2 * o, inv_s2[o]);
    const bool in = valid[o] && (!gate || (r.chi2 <= chi2_th && r.z > 0.f));
    inliers_out[o] = in;
    acc[0] += in ? huber_cost(r.chi2) : 0.f;
  }
  block_sum(acc, part, total);
  if (threadIdx.x == 0) cost_out[p] = acc[0];
}

}  // namespace

// Plain C entry points (loaded with ctypes), their arguments in the order
// of the wrapper's.  Every pointer is a device pointer to a contiguous
// float32 array (bool: one byte) with a leading axis of `batch` problems:
// pose [batch, 7], lam and cost [batch], points [batch, n, 3], uv [batch,
// n, 2], inv_s2 [batch, n], inliers / valid [batch, n], K [batch, 3, 3];
// the outputs likewise.  Each launches on `stream` without synchronising
// and returns the first cudaError_t (cudaErrorInvalidValue for a negative
// n or an empty or too large a batch).
extern "C" int pose_lm_step_launch(const float* pose, const float* lam, const float* cost,
                                   const float* points, const float* uv, const float* inv_s2,
                                   const bool* inliers, const float* K, int n, int batch,
                                   int use_huber, float* pose_out, float* lam_out,
                                   float* cost_out, void* stream) {
  if (n < 0 || batch <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  pose_lm_step_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      pose, lam, cost, points, uv, inv_s2, inliers, K, n, use_huber, pose_out, lam_out,
      cost_out);
  return (int)cudaGetLastError();
}

extern "C" int pose_lm_gate_launch(const float* pose, const float* points, const float* uv,
                                   const float* inv_s2, const bool* valid, const float* K,
                                   int n, int batch, float chi2_th, int gate,
                                   bool* inliers_out, float* cost_out, void* stream) {
  if (n < 0 || batch <= 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  pose_lm_gate_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      pose, points, uv, inv_s2, valid, K, n, chi2_th, gate, inliers_out, cost_out);
  return (int)cudaGetLastError();
}
