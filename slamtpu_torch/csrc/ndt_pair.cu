// Pair kernels of the registration objective, written for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of slamtpu/ndt/pallas_math.py:
//   ndt_pair_kernel    <- _kernel with gicp=False (+ _finish_block): the NDT
//                         pair math of SVN stage 1 and Newton;
//   aniso_pair_kernel  <- _kernel_aniso (+ _finish_block): plane-to-plane
//                         GICP, the SVN polish.
// Both reduce to the same 44 sums per pose: [0] score, [1:4] grad omega,
// [4:7] grad v, [7:43] Gauss-Newton Hessian row-major in [omega, v],
// [43] count of contributing pairs. The caller adds lambda * I.
//
// Shape. One thread per point; the 7 DIRECT7 slots of its 96-float mega row
// loop in registers. Each thread forms its point's score, count, b = sum f
// icov xr (3) and M = sum f icov (9), then q = R^T b, P = R^T M R and the 21
// unique Hessian terms. The block reduces its 29 sums in shared memory in a
// fixed tree order and writes them to a per-block partial; a second kernel
// sums the partials of each pose in block order, in double. No atomics: the
// result repeats bit for bit from run to run (Newton and the SVN flow
// amplify reduction noise). This takes the place of the TPU's sequential
// grid accumulator; Hopper runs blocks in no order.
//
// Batch. params is (K, 16): R row-major (9), t (3), d1, d2, mode (unused,
// must be 0), max_mahal. The grid's second axis runs over the K poses, so
// the K = 20 particles of SVN stage 1 are one launch against one megaT.
//
// Bound. Per point and pose the kernel reads 96 + 3 floats (+ 9 for the
// plane-to-plane source covariance): about 400 bytes against some 800
// flops, far below the card's ratio of flops to bytes of device memory
// (~20), so by roofline it is bound by memory. The design keeps the inputs
// planar ((3, N), (96, N), (9, N)) so that neighbouring threads read
// neighbouring addresses, reads each value once per pose, and keeps every
// intermediate in registers. The K poses of one launch re-read the same
// megaT (25 MB at 65,536 points), which the 50 MB L2 can hold. Gathering
// the rows inside the kernel instead of from a pre-gathered megaT, and
// cell-sorted coalesced gathers, are later work.
//
// The ragged edge (N not a multiple of the block) is masked in the kernel.
// Padding points carry the all-zero sentinel row: every slot invalid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAcc = 29;  // score, count, grad(6), 21 unique Hessian terms
constexpr int kOut = 44;

struct Pose {
  float R[9];
  float t[3];
};

__device__ __forceinline__ void load_pose(const float* __restrict__ p, Pose& ps) {
#pragma unroll
  for (int c = 0; c < 9; ++c) ps.R[c] = p[c];
#pragma unroll
  for (int c = 0; c < 3; ++c) ps.t[c] = p[9 + c];
}

// acc layout: [0] score, [1] count, [2..4] grad omega, [5..7] grad v,
// [8..13] H_ww upper (00 01 02 11 12 22), [14..22] H_wv (row-major),
// [23..28] H_vv upper (00 01 02 11 12 22).
__device__ __forceinline__ void finish_point(const Pose& ps, float x0, float x1, float x2,
                                             float b0, float b1, float b2, const float M[9],
                                             float* acc) {
  const float* R = ps.R;
  // gradient: q = R^T b; g_w = x cross q; g_v = q
  const float q0 = R[0] * b0 + R[3] * b1 + R[6] * b2;
  const float q1 = R[1] * b0 + R[4] * b1 + R[7] * b2;
  const float q2 = R[2] * b0 + R[5] * b1 + R[8] * b2;
  acc[2] += x1 * q2 - x2 * q1;
  acc[3] += x2 * q0 - x0 * q2;
  acc[4] += x0 * q1 - x1 * q0;
  acc[5] += q0;
  acc[6] += q1;
  acc[7] += q2;
  // P = R^T M R
  float P[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bc = 0; bc < 3; ++bc) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) s += (R[3 * i + a] * R[3 * j + bc]) * M[3 * i + j];
      }
      P[a][bc] = s;
    }
  }
  // Q[:, bc] = x cross P[:, bc]  (H_wv = Q); H_ww[a, :] = x cross Q[a, :]
  float Q[3][3];
#pragma unroll
  for (int bc = 0; bc < 3; ++bc) {
    Q[0][bc] = x1 * P[2][bc] - x2 * P[1][bc];
    Q[1][bc] = x2 * P[0][bc] - x0 * P[2][bc];
    Q[2][bc] = x0 * P[1][bc] - x1 * P[0][bc];
  }
  float W[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    W[a][0] = x1 * Q[a][2] - x2 * Q[a][1];
    W[a][1] = x2 * Q[a][0] - x0 * Q[a][2];
    W[a][2] = x0 * Q[a][1] - x1 * Q[a][0];
  }
  acc[8] += W[0][0];
  acc[9] += W[0][1];
  acc[10] += W[0][2];
  acc[11] += W[1][1];
  acc[12] += W[1][2];
  acc[13] += W[2][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int bc = 0; bc < 3; ++bc) acc[14 + 3 * a + bc] += Q[a][bc];
  }
  acc[23] += P[0][0];
  acc[24] += P[0][1];
  acc[25] += P[0][2];
  acc[26] += P[1][1];
  acc[27] += P[1][2];
  acc[28] += P[2][2];
}

// Fixed-order tree reduction of the block's kAcc sums; thread 0 writes the
// 44-wide partial (Hessian mirrored from its unique terms).
__device__ __forceinline__ void block_reduce_store(float* acc, float* __restrict__ partial) {
  __shared__ float sh[kAcc][kThreads];
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) sh[c][tid] = acc[c];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int c = 0; c < kAcc; ++c) sh[c][tid] += sh[c][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    float o[kOut];
    o[0] = sh[0][0];
    o[43] = sh[1][0];
    for (int c = 0; c < 6; ++c) o[1 + c] = sh[2 + c][0];
    const int up[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
    for (int a = 0; a < 3; ++a) {
      for (int bc = 0; bc < 3; ++bc) {
        o[7 + 6 * a + bc] = sh[8 + up[a][bc]][0];                 // H_ww
        o[7 + 6 * a + 3 + bc] = sh[14 + 3 * a + bc][0];           // H_wv
        o[7 + 6 * (3 + bc) + a] = sh[14 + 3 * a + bc][0];         // H_vw
        o[7 + 6 * (3 + a) + 3 + bc] = sh[23 + up[a][bc]][0];      // H_vv
      }
    }
    for (int c = 0; c < kOut; ++c) partial[c] = o[c];
  }
}

__global__ void __launch_bounds__(kThreads)
ndt_pair_kernel(const float* __restrict__ params, const float* __restrict__ ptsT,
                const float* __restrict__ megaT, int N, float* __restrict__ partials) {
  const int k = blockIdx.y;
  Pose ps;
  load_pose(params + 16 * k, ps);
  const float d1 = params[16 * k + 12];
  const float d2 = params[16 * k + 13];
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < N) {
    const float x0 = ptsT[i], x1 = ptsT[N + i], x2 = ptsT[2 * N + i];
    const float* R = ps.R;
    const float tp0 = R[0] * x0 + R[1] * x1 + R[2] * x2 + ps.t[0];
    const float tp1 = R[3] * x0 + R[4] * x1 + R[5] * x2 + ps.t[1];
    const float tp2 = R[6] * x0 + R[7] * x1 + R[8] * x2 + ps.t[2];
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
    float M[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) M[c] = 0.f;
#pragma unroll
    for (int s = 0; s < 7; ++s) {
      const float* row = megaT + (size_t)(12 * s) * N + i;
      const float xr0 = tp0 - row[0];
      const float xr1 = tp1 - row[(size_t)N];
      const float xr2 = tp2 - row[(size_t)2 * N];
      float ic[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) ic[c] = row[(size_t)(3 + c) * N];
      const bool valid = megaT[(size_t)(84 + s) * N + i] > 0.5f;
      const float icx0 = ic[0] * xr0 + ic[1] * xr1 + ic[2] * xr2;
      const float icx1 = ic[3] * xr0 + ic[4] * xr1 + ic[5] * xr2;
      const float icx2 = ic[6] * xr0 + ic[7] * xr1 + ic[8] * xr2;
      const float mahal = fmaxf(xr0 * icx0 + xr1 * icx1 + xr2 * icx2, 0.f);
      const float expo = 0.5f * d2 * mahal;
      const bool ok = valid && (expo <= 50.0f);  // MAX_EXPONENT_ARG
      const float e = expf(-(ok ? expo : 0.f));
      float f = d1 * d2 * e;
      f = (ok && fabsf(f) >= 1e-15f) ? f : 0.f;  // MIN_FACTOR
      if (ok) {
        acc[0] += -d1 * e;
        acc[1] += 1.f;
      }
      b0 += f * icx0;
      b1 += f * icx1;
      b2 += f * icx2;
#pragma unroll
      for (int c = 0; c < 9; ++c) M[c] += f * ic[c];
    }
    finish_point(ps, x0, x1, x2, b0, b1, b2, M, acc);
  }
  block_reduce_store(acc, partials + ((size_t)k * gridDim.x + blockIdx.x) * kOut);
}

__global__ void __launch_bounds__(kThreads)
aniso_pair_kernel(const float* __restrict__ params, const float* __restrict__ ptsT,
                  const float* __restrict__ megaT, const float* __restrict__ scovT, int N,
                  float* __restrict__ partials) {
  const int k = blockIdx.y;
  Pose ps;
  load_pose(params + 16 * k, ps);
  const float corr2 = params[16 * k + 13];
  const float max_mahal = params[16 * k + 15];
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < N) {
    const float x0 = ptsT[i], x1 = ptsT[N + i], x2 = ptsT[2 * N + i];
    const float* R = ps.R;
    const float tp0 = R[0] * x0 + R[1] * x1 + R[2] * x2 + ps.t[0];
    const float tp1 = R[3] * x0 + R[4] * x1 + R[5] * x2 + ps.t[1];
    const float tp2 = R[6] * x0 + R[7] * x1 + R[8] * x2 + ps.t[2];
    // rc = R C_src R^T (C_src row-major in scovT)
    float sc[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) sc[c] = scovT[(size_t)c * N + i];
    float RC[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        RC[a][b] = R[3 * a] * sc[b] + R[3 * a + 1] * sc[3 + b] + R[3 * a + 2] * sc[6 + b];
    }
    float rc[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        rc[a][b] = RC[a][0] * R[3 * b] + RC[a][1] * R[3 * b + 1] + RC[a][2] * R[3 * b + 2];
    }
    float b0 = 0.f, b1 = 0.f, b2 = 0.f;
    float M[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) M[c] = 0.f;
#pragma unroll
    for (int s = 0; s < 7; ++s) {
      const float* row = megaT + (size_t)(12 * s) * N + i;
      const float xr0 = tp0 - row[0];
      const float xr1 = tp1 - row[(size_t)N];
      const float xr2 = tp2 - row[(size_t)2 * N];
      const float* ct = row + (size_t)3 * N;
      const bool valid = megaT[(size_t)(84 + s) * N + i] > 0.5f;
      // fused symmetric S = C_t + rc, closed-form adjugate inverse
      const float s00 = ct[0] + rc[0][0];
      const float s01 = ct[(size_t)N] + rc[0][1];
      const float s02 = ct[(size_t)2 * N] + rc[0][2];
      const float s11 = ct[(size_t)4 * N] + rc[1][1];
      const float s12 = ct[(size_t)5 * N] + rc[1][2];
      const float s22 = ct[(size_t)8 * N] + rc[2][2];
      const float c00 = s11 * s22 - s12 * s12;
      const float c01 = s02 * s12 - s01 * s22;
      const float c02 = s01 * s12 - s02 * s11;
      const float c11 = s00 * s22 - s02 * s02;
      const float c12 = s01 * s02 - s00 * s12;
      const float c22 = s00 * s11 - s01 * s01;
      const float det = s00 * c00 + s01 * c01 + s02 * c02;
      const float inv_det = 1.f / (fabsf(det) > 1e-30f ? det : 1.f);
      const float i00 = c00 * inv_det, i01 = c01 * inv_det, i02 = c02 * inv_det;
      const float i11 = c11 * inv_det, i12 = c12 * inv_det, i22 = c22 * inv_det;
      const float icx0 = i00 * xr0 + i01 * xr1 + i02 * xr2;
      const float icx1 = i01 * xr0 + i11 * xr1 + i12 * xr2;
      const float icx2 = i02 * xr0 + i12 * xr1 + i22 * xr2;
      const float mahal = fmaxf(xr0 * icx0 + xr1 * icx1 + xr2 * icx2, 0.f);
      const float dist2 = xr0 * xr0 + xr1 * xr1 + xr2 * xr2;
      const bool ok = valid && (mahal <= max_mahal) && (dist2 <= corr2);
      const float f = ok ? -2.f : 0.f;
      if (ok) {
        acc[0] += -mahal;
        acc[1] += 1.f;
      }
      b0 += f * icx0;
      b1 += f * icx1;
      b2 += f * icx2;
      M[0] += f * i00;
      M[1] += f * i01;
      M[2] += f * i02;
      M[3] += f * i01;
      M[4] += f * i11;
      M[5] += f * i12;
      M[6] += f * i02;
      M[7] += f * i12;
      M[8] += f * i22;
    }
    finish_point(ps, x0, x1, x2, b0, b1, b2, M, acc);
  }
  block_reduce_store(acc, partials + ((size_t)k * gridDim.x + blockIdx.x) * kOut);
}

// out[k, c] = sum over blocks of partials[k, b, c], in block order, in double.
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                                       float* __restrict__ out) {
  const int k = blockIdx.x;
  const int c = threadIdx.x;
  if (c >= kOut) return;
  double s = 0.0;
  const float* p = partials + (size_t)k * n_blocks * kOut + c;
  for (int b = 0; b < n_blocks; ++b) s += (double)p[(size_t)b * kOut];
  out[k * kOut + c] = (float)s;
}

int finish_launch(const float* partials, int n_blocks, int K, float* out, cudaStream_t st) {
  reduce_partials_kernel<<<K, 64, 0, st>>>(partials, n_blocks, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ndt_pair_threads() { return kThreads; }

const char* ndt_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// partials: (K, ceil(N / threads), 44) scratch; out: (K, 44).
int ndt_pair_launch(const float* params, const float* ptsT, const float* megaT, int N, int K,
                    float* partials, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = (N + kThreads - 1) / kThreads;
  if (K <= 0) return 0;
  if (n_blocks > 0) {
    ndt_pair_kernel<<<dim3(n_blocks, K), kThreads, 0, st>>>(params, ptsT, megaT, N, partials);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return finish_launch(partials, n_blocks, K, out, st);
}

int aniso_pair_launch(const float* params, const float* ptsT, const float* megaT,
                      const float* scovT, int N, int K, float* partials, float* out,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = (N + kThreads - 1) / kThreads;
  if (K <= 0) return 0;
  if (n_blocks > 0) {
    aniso_pair_kernel<<<dim3(n_blocks, K), kThreads, 0, st>>>(params, ptsT, megaT, scovT, N,
                                                               partials);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return finish_launch(partials, n_blocks, K, out, st);
}

}  // extern "C"
