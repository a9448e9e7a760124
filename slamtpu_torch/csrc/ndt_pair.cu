// Pair kernels of the registration objective, written for Hopper (sm_90a).
//
// Replaces the Pallas kernels of slamtpu/ndt/pallas_math.py, one kernel
// template with the cost as its parameter:
//   ndt_pair_kernel<kNdt>   <- _kernel with gicp=False (+ _finish_block): the
//                              NDT pair math of SVN stage 1 and Newton (B1);
//   ndt_pair_kernel<kGicp>  <- _kernel with gicp=True (+ _finish_block): the
//                              trimmed isotropic VGICP cost of odom_ndt's
//                              GICP engine (its map bakes (C + s^2 I)^-1 into
//                              the icov slots) (B2);
//   ndt_pair_kernel<kAniso> <- _kernel_aniso (+ _finish_block): plane-to-plane
//                              GICP, the SVN polish (B3).
// B1 and B2 also come gated (template flag Gate), for the KDTREE search
// mode: the reference zeroes the validity flag of each slot whose centroid
// lies farther than the radius from the point at the GATHER pose, as it
// gathers the rows (gather_megaT with kd_radius, pallas_math.py:294-317);
// here the kernel gathers the rows, so it applies the gate itself.
// All reduce to the same 44 sums per pose: [0] score, [1:4] grad omega,
// [4:7] grad v, [7:43] Gauss-Newton Hessian row-major in [omega, v],
// [43] count of contributing pairs. The caller adds lambda * I.
//
// params is (K, 16): R row-major (9), t (3), d1, d2, mode, max_mahal. The
// mode slot is written as the reference writes it (1 for the VGICP cost)
// but not read: the kernel's template parameter selects the cost, as the
// reference's trace-time ``gicp`` flag and its choice of kernel do. In the
// VGICP and plane-to-plane costs d1 is unused and d2 carries
// max_corr_dist^2.
//
// Inputs: a RegMap table (R, 96) row-major (a point's 96-float mega row:
// 7 DIRECT7 slots of mean(3) + a 3x3 matrix(9) at 12 s, validity flags at
// 84..90; the last row R - 1 is the all-zero sentinel) and each point's row
// index rows (N,) int32 (``regmap.grid_rows``). B1 and B2 read the icov
// table (``regmap.packed``); B3 reads the aux table (``regmap.packed_aux``:
// the slot's mean and plane-regularized target covariance C_t) and each
// point's body-frame source covariance C_src, scovT (9, N) planar. The
// kernel gathers the rows itself: the reference gathers them outside its
// kernels only because Mosaic cannot gather from large tables.
//
// The gate (Gate = true): a (16,) float block g = R_g row-major (9), t_g
// (3), r^2, pad, where (R_g, t_g) is the pose at which the rows were looked
// up (the particle mean in SVN, the outer iteration's pose in Newton, whose
// inner steps reuse rows and gate). A lane computes q = R_g x + t_g once per
// point and tile, from the row it already holds in registers, and clears
// slot s of its valid bits unless |q - mu_s|^2 <= r^2, before the pose
// loop. The ungated instantiations compile without it.
//
// B3 per pair: S = C_t + R C_src R^T, its closed-form adjugate inverse
// (det taken as 1 unless |det| > 1e-30, as the reference), then B2's
// trimmed quadratic with S^-1 in place of icov. R C_src R^T is formed once
// per point-pose; only the upper triangles of R C_src R^T, S and S^-1 are
// computed (all are symmetric).
//
// What bounds it on the H100. At the SVN's K = 20 poses, fp32 issue: each
// point-pose costs some 400 flops (with the Hessian tail in the rotated
// frame) plus a 29-value warp reduction, against one 368-byte row that all
// K poses share; a thread holds its row in registers (84 + 1) and two poses'
// work at a time, so registers (168 a thread at 12 warps an SM) cap the
// warps that hide latency (B3's per-pair inverse fits the same budget). At
// K = 1 (Newton, the polish), latency: a launch is a chain of dependent
// steps (row indices, row copies, one pose, the two-level cross-block sum)
// of ~10 us before its points count, and the row copies contend where many
// points read the same row.
//
// Design.
// - Persistent blocks (three per SM, 4 warps each) walk 32-point tiles in a
//   fixed order through a ring of 4 tiles in shared memory. Warp s fills
//   slot s: each point's row arrives by a 1-D bulk asynchronous copy
//   (cp.async.bulk, 368 B: the 91 floats the math reads, 16-B aligned at
//   row * 384) that completes on the slot's mbarrier, while the warps
//   compute earlier tiles. Points of a tile that share a row share one copy
//   (__match_any_sync); the sentinel row is not copied. 16-byte cp.async
//   copies by the warp's lanes measured the same as bulk copies.
// - A lane reads its point's row out of shared memory once (23 float4
//   loads; the 368-B pitch puts the 8 lanes of a quarter warp on 8 distinct
//   4-bank groups, so the loads are free of bank conflicts), and keeps it
//   in registers for all the poses it evaluates: a tile's rows cross L2 once
//   per launch, not K times. Pose pair p of tile j goes to warp
//   (j + p) mod 4, so every warp works at K = 1 and the pairs of K = 20
//   spread over the warps; two poses at once give the scheduler two
//   independent chains (four spill at the register cap).
//   B3's lanes also load their points' 9 source-covariance values straight
//   from global memory, coalesced, as they load the points.
// - After each pose a warp reduce-scatters its 29 per-point sums with 31
//   shuffles (lane l ends with sum l) and adds them to its own shared
//   accumulator of that pose. The block sums its warps in warp order into
//   one partial per pose; the last block of each group of 16 (an atomic
//   ticket) sums the group's partials in block order in double, and the
//   last group sums the groups in order, rotates each pose's sums back
//   (R^T . R, in double) and writes the (K, 44) result; each finisher
//   resets its ticket. One launch, no atomics on the data, so results
//   repeat bit for bit; the tiling depends on N and the card only, so a
//   pose's sums do not depend on K or on the other poses.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Cost { kNdt = 0, kGicp = 1, kAniso = 2 };  // B1, B2, B3

constexpr int kAcc = 29;  // score, count, grad(6), 21 unique Hessian terms
constexpr int kOut = 44;

// ndt_pair_kernel geometry
constexpr int kPairWarps = 4;                          // warps a block
constexpr int kPairThreads = 32 * kPairWarps;
constexpr int kTile = 32;                              // points a tile, one a lane
constexpr int kStages = 4;                             // ring of tiles
constexpr int kPitch = 92;                             // floats a row in shared memory
constexpr int kRowBytes = 4 * kPitch;                  // 368: a multiple of 16
constexpr int kTableCols = 96;
constexpr int kBlocksPerSM = 3;
constexpr int kMaxPoses = 200;                         // shared-memory limit on K
constexpr int kGroup = 16;                             // blocks a first-level sum takes
constexpr int kBatch = 16;                             // loads in flight a sum (ordered_sums)
constexpr int kOuts = 4;                               // sums a thread loads for at once
constexpr unsigned char kNoRow = 0xff;                 // fill_slot: no row for this point
constexpr size_t kRingFloats = (size_t)kStages * kTile * kPitch;
// the last block sums the K poses' partials into the ring, in double
static_assert(kMaxPoses * kAcc * sizeof(double) <= kRingFloats * sizeof(float), "ring");

// --- mbarrier and bulk-copy primitives (PTX) ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy global -> shared, completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// --- the pair math ---

// The KDTREE gate: the valid bits of a point's row, less the slots whose
// centroid mu_s (row[12 s .. 12 s + 2]) lies farther than r from the point
// at the gather pose, q = R_g x + t_g (g: R_g(9), t_g(3), r^2, pad). A NaN
// distance fails the test, as in the plain version.
__device__ __forceinline__ unsigned gate_slots(const float* __restrict__ g, float x0, float x1,
                                               float x2, const float (&row)[84], unsigned valid) {
  const float4* gp = reinterpret_cast<const float4*>(g);
  const float4 g0 = __ldg(gp), g1 = __ldg(gp + 1), g2 = __ldg(gp + 2), g3 = __ldg(gp + 3);
  const float q0 = g0.x * x0 + g0.y * x1 + g0.z * x2 + g2.y;
  const float q1 = g0.w * x0 + g1.x * x1 + g1.y * x2 + g2.z;
  const float q2 = g1.z * x0 + g1.w * x1 + g2.x * x2 + g2.w;
#pragma unroll
  for (int s = 0; s < 7; ++s) {
    const float d0 = q0 - row[12 * s], d1 = q1 - row[12 * s + 1], d2 = q2 - row[12 * s + 2];
    if (!(d0 * d0 + d1 * d1 + d2 * d2 <= g3.x)) valid &= ~(1u << s);
  }
  return valid;
}

__device__ __forceinline__ int upper3(int a, int b) {
  const int i = min(a, b), j = max(a, b);
  return i * (5 - i) / 2 + j;  // 00 01 02 11 12 22 -> 0..5
}

// One point's 29 sums at NP poses (params p, p + pstride, ...) into
// v[q][0..28] (v[q][29..31] = 0), in the rotated frame y = R x: with
// b = sum f W xr and M = sum f W over the slots (W the pair's icov, or S^-1
// for B3), [0] score, [1] count, [2..4] y x b, [5..7] b, [8..13]
// hat(y) M hat(y)^T upper (00 01 02 11 12 22), [14..22] hat(y) M
// (row-major), [23..28] M upper. The pose's gradient and Hessian are
// R^T (sum) R of these (rotate_output): x cross (R^T b) = R^T (y cross b)
// and hat(x) R^T M R = R^T hat(y) M R, so the per-point tail needs no R.
// The poses' arithmetic is written once and interleaved (NP = 2 gives the
// scheduler two independent chains); each pose's result does not depend
// on NP.
// kNdt: NDT pair weight, score -d1 e, f = d1 d2 e (exponent cap, MIN_FACTOR
// cut). kGicp and kAniso: the pair counts if valid, mahal <= max_mahal and
// |xr|^2 <= d2; score -mahal, f = -2. kAniso reads the slot's target
// covariance C_t where the others read icov, and sc, the point's source
// covariance (row-major), which the others do not read.
template <Cost C, int NP>
__device__ __forceinline__ void pair_terms(const float* __restrict__ p, int pstride, float x0,
                                           float x1, float x2, const float (&sc)[9],
                                           const float (&row)[84], unsigned valid,
                                           float (&v)[NP][32]) {
  float y[NP][3], tp[NP][3], d1[NP], d2[NP], max_mahal[NP];
  float score[NP], count[NP], b[NP][3], M[NP][9];
  float rc[NP][6];  // kAniso: R C_src R^T, upper (00 01 02 11 12 22)
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const float4* pp = reinterpret_cast<const float4*>(p + pstride * q);
    const float4 p0 = pp[0], p1 = pp[1], p2 = pp[2], p3 = pp[3];
    const float R[9] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x};
    y[q][0] = R[0] * x0 + R[1] * x1 + R[2] * x2;
    y[q][1] = R[3] * x0 + R[4] * x1 + R[5] * x2;
    y[q][2] = R[6] * x0 + R[7] * x1 + R[8] * x2;
    tp[q][0] = y[q][0] + p2.y;
    tp[q][1] = y[q][1] + p2.z;
    tp[q][2] = y[q][2] + p2.w;
    d1[q] = p3.x;
    d2[q] = p3.y;
    max_mahal[q] = p3.w;
    score[q] = count[q] = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) b[q][c] = 0.f;
#pragma unroll
    for (int c = 0; c < 9; ++c) M[q][c] = 0.f;
    if constexpr (C == kAniso) {
      float RC[3][3];  // R C_src
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          RC[a][c] = R[3 * a] * sc[c] + R[3 * a + 1] * sc[3 + c] + R[3 * a + 2] * sc[6 + c];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int c = a; c < 3; ++c)
          rc[q][upper3(a, c)] =
              RC[a][0] * R[3 * c] + RC[a][1] * R[3 * c + 1] + RC[a][2] * R[3 * c + 2];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 7; ++s) {
    const float* sl = row + 12 * s;
    const float* ic = sl + 3;
    const bool valid_s = (valid >> s) & 1u;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const float xr0 = tp[q][0] - sl[0], xr1 = tp[q][1] - sl[1], xr2 = tp[q][2] - sl[2];
      float w[9];  // the pair's weight matrix: icov, or S^-1
      if constexpr (C == kAniso) {
        // fused symmetric S = C_t + rc, closed-form adjugate inverse
        const float s00 = ic[0] + rc[q][0], s01 = ic[1] + rc[q][1], s02 = ic[2] + rc[q][2];
        const float s11 = ic[4] + rc[q][3], s12 = ic[5] + rc[q][4], s22 = ic[8] + rc[q][5];
        const float c00 = s11 * s22 - s12 * s12;
        const float c01 = s02 * s12 - s01 * s22;
        const float c02 = s01 * s12 - s02 * s11;
        const float c11 = s00 * s22 - s02 * s02;
        const float c12 = s01 * s02 - s00 * s12;
        const float c22 = s00 * s11 - s01 * s01;
        const float det = s00 * c00 + s01 * c01 + s02 * c02;
        const float inv_det = 1.f / (fabsf(det) > 1e-30f ? det : 1.f);
        w[0] = c00 * inv_det;
        w[1] = w[3] = c01 * inv_det;
        w[2] = w[6] = c02 * inv_det;
        w[4] = c11 * inv_det;
        w[5] = w[7] = c12 * inv_det;
        w[8] = c22 * inv_det;
      } else {
#pragma unroll
        for (int c = 0; c < 9; ++c) w[c] = ic[c];
      }
      const float wx0 = w[0] * xr0 + w[1] * xr1 + w[2] * xr2;
      const float wx1 = w[3] * xr0 + w[4] * xr1 + w[5] * xr2;
      const float wx2 = w[6] * xr0 + w[7] * xr1 + w[8] * xr2;
      const float mahal = fmaxf(xr0 * wx0 + xr1 * wx1 + xr2 * wx2, 0.f);
      bool ok;
      float f, pair_score;
      if constexpr (C == kNdt) {
        const float expo = 0.5f * d2[q] * mahal;
        ok = valid_s && (expo <= 50.0f);  // MAX_EXPONENT_ARG
        const float e = expf(-expo);  // used only where ok
        f = d1[q] * d2[q] * e;
        f = (ok && fabsf(f) >= 1e-15f) ? f : 0.f;  // MIN_FACTOR
        pair_score = -d1[q] * e;
      } else {
        const float dist2 = xr0 * xr0 + xr1 * xr1 + xr2 * xr2;
        ok = valid_s && (mahal <= max_mahal[q]) && (dist2 <= d2[q]);
        f = ok ? -2.f : 0.f;
        pair_score = -mahal;
      }
      if (ok) {
        score[q] += pair_score;
        count[q] += 1.f;
      }
      b[q][0] += f * wx0;
      b[q][1] += f * wx1;
      b[q][2] += f * wx2;
#pragma unroll
      for (int c = 0; c < 9; ++c) M[q][c] += f * w[c];
    }
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const float y0 = y[q][0], y1 = y[q][1], y2 = y[q][2];
    const float* m = M[q];
    float* o = v[q];
    o[0] = score[q];
    o[1] = count[q];
    o[2] = y1 * b[q][2] - y2 * b[q][1];
    o[3] = y2 * b[q][0] - y0 * b[q][2];
    o[4] = y0 * b[q][1] - y1 * b[q][0];
    o[5] = b[q][0];
    o[6] = b[q][1];
    o[7] = b[q][2];
    // Q[:, c] = y cross M[:, c]; W[a, :] = y cross Q[a, :]
    float Q[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Q[0][c] = y1 * m[6 + c] - y2 * m[3 + c];
      Q[1][c] = y2 * m[c] - y0 * m[6 + c];
      Q[2][c] = y0 * m[3 + c] - y1 * m[c];
    }
    o[8] = y1 * Q[0][2] - y2 * Q[0][1];
    o[9] = y2 * Q[0][0] - y0 * Q[0][2];
    o[10] = y0 * Q[0][1] - y1 * Q[0][0];
    o[11] = y2 * Q[1][0] - y0 * Q[1][2];
    o[12] = y0 * Q[1][1] - y1 * Q[1][0];
    o[13] = y0 * Q[2][1] - y1 * Q[2][0];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) o[14 + 3 * a + c] = Q[a][c];
    }
    o[23] = m[0];
    o[24] = m[1];
    o[25] = m[2];
    o[26] = m[4];
    o[27] = m[5];
    o[28] = m[8];
    o[29] = o[30] = o[31] = 0.f;
  }
}

// Output o (0..43) of one pose from its 29 rotated-frame sums s (see
// pair_terms) and its rotation R: the gradient R^T g, the Hessian blocks
// R^T B R of the (mirrored) sums, in double.
__device__ double rotate_output(const double* s, const float* R, int o) {
  if (o == 0) return s[0];
  if (o == 43) return s[1];
  if (o < 7) {
    const double* g = s + (o < 4 ? 2 : 5);
    const int a = (o - 1) % 3;
    return (double)R[a] * g[0] + (double)R[3 + a] * g[1] + (double)R[6 + a] * g[2];
  }
  const int a = (o - 7) / 6, b = (o - 7) % 6;
  double B[3][3];  // the block's sum in the rotated frame
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (a < 3 && b < 3) B[i][j] = s[8 + upper3(i, j)];  // H_ww
      else if (a < 3) B[i][j] = s[14 + 3 * i + j];         // H_wv
      else if (b < 3) B[i][j] = s[14 + 3 * j + i];         // H_vw = H_wv^T
      else B[i][j] = s[23 + upper3(i, j)];                 // H_vv
    }
  }
  const int r = a % 3, c = b % 3;
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) acc += (double)R[3 * i + r] * B[i][j] * (double)R[3 * j + c];
  }
  return acc;
}

// One halving step of the warp's reduce-scatter over 32 values: a lane
// keeps the half selected by its bit H and adds its partner's copy of it.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? v[j] : v[j + H];
    const float keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// Sum of v[lane] over the warp's 32 lanes, in a fixed order (31 shuffles).
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

// NP poses of one point per lane, pose_stride apart (params p + 16
// pose_stride q): the warp's sums of each added to its accumulators
// acc[32 pose_stride q] (the lane's own column).
template <Cost C, int NP>
__device__ __forceinline__ void pose_block(const float* __restrict__ p, int pose_stride, float x0,
                                           float x1, float x2, const float (&sc)[9],
                                           const float (&row)[84], unsigned valid, bool have,
                                           int lane, float* acc) {
  float v[NP][32];
  if (have) {
    pair_terms<C, NP>(p, 16 * pose_stride, x0, x1, x2, sc, row, valid, v);
  } else {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
#pragma unroll
      for (int c = 0; c < 32; ++c) v[q][c] = 0.f;
    }
  }
  float sum[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) sum[q] = warp_reduce_scatter(v[q], lane);
#pragma unroll
  for (int q = 0; q < NP; ++q) acc[32 * pose_stride * q] += sum[q];
}

// dst[i] = p[i] + p[stride + i] + ... + p[(n - 1) stride + i], in that
// order, in double, for i = tid, tid + kPairThreads, ... < total. A thread
// loads kBatch values of each of up to kOuts outputs before it adds, so
// that the loads' latencies overlap.
template <typename T>
__device__ __forceinline__ void ordered_sums(const T* __restrict__ p, size_t stride, int n,
                                             int total, int tid, double* __restrict__ dst) {
  for (int i0 = tid; i0 < total; i0 += kOuts * kPairThreads) {
    double acc[kOuts];
#pragma unroll
    for (int o = 0; o < kOuts; ++o) acc[o] = 0.0;
    for (int b = 0; b < n; b += kBatch) {
      T buf[kOuts][kBatch];
#pragma unroll
      for (int o = 0; o < kOuts; ++o) {
        const int i = i0 + o * kPairThreads;
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          buf[o][u] = (i < total && b + u < n) ? __ldcg(p + (b + u) * stride + i) : T(0);
      }
#pragma unroll
      for (int o = 0; o < kOuts; ++o) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (b + u < n) acc[o] += (double)buf[o][u];
      }
    }
#pragma unroll
    for (int o = 0; o < kOuts; ++o)
      if (i0 + o * kPairThreads < total) dst[i0 + o * kPairThreads] = acc[o];
  }
}

__host__ __device__ constexpr size_t pair_smem_bytes(int K) {
  return 4 * (kRingFloats + (size_t)16 * K + (size_t)kPairWarps * K * 32) + kStages * kTile;
}

// One warp fills ring slot s with tile j's rows (tile j of this block:
// points (blockIdx.x + j gridDim.x) kTile + 0..kTile-1, point i on lane i).
// Points of the tile that share a row share one copy: the lowest lane of
// each group of equal rows (__match_any_sync) copies it with a 368-byte
// bulk copy (cp.async.bulk, the TMA's 1-D form) into its own place in the
// slot, completing its bytes on `full`, and lead[i] names the lane whose
// place holds point i's row. The sentinel row R - 1 (all zero: no valid
// slot) is not copied: lead[i] = kNoRow, and point i adds nothing. An
// index outside the table reads the sentinel.
__device__ __forceinline__ void fill_slot(int j, int s, const int* __restrict__ rows,
                                          const float* __restrict__ table, int N, int R,
                                          float* ring, unsigned char* lead, uint64_t* full,
                                          int lane) {
  const int base = ((int)blockIdx.x + j * (int)gridDim.x) * kTile;
  const int n = min(kTile, N - base);
  int r = lane < n ? rows[base + lane] : R - 1;
  if (r < 0 || r >= R) r = R - 1;
  const unsigned peers = __match_any_sync(0xffffffffu, r);
  const int leader = __ffs(peers) - 1;
  const unsigned leaders = __ballot_sync(0xffffffffu, lane == leader && r != R - 1);
  lead[s * kTile + lane] = r != R - 1 ? (unsigned char)leader : kNoRow;
  // the slot's previous rows were read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive_expect_tx(full, (uint32_t)(__popc(leaders) * kRowBytes));
  if ((leaders >> lane) & 1u)
    bulk_g2s(ring + ((size_t)s * kTile + lane) * kPitch, table + (size_t)r * kTableCols, kRowBytes,
             full);
}

// A block's kPairWarps warps share a ring of kStages tiles of kTile points.
// Poses 2p and 2p + 1 of tile j are evaluated together (pose_block<2>) by
// warp (j + p) mod kPairWarps, so all warps work at K = 1 (on different
// tiles) and at K = 20 each tile's ten pairs split over the warps; the
// mapping does not depend on K. Warp j mod kStages (always a reader of
// tile j) refills tile j's slot with tile j + kStages once all of its
// readers (min(ceil(K / 2), kPairWarps) warps) have their rows. Dynamic
// shared memory: the ring (kStages x kTile rows of kPitch floats), the K
// poses' params, each warp's 32 accumulators per pose, and the ring's
// lead lanes (fill_slot).
// scovT: (9, N) source covariances (kAniso only; unread otherwise); gate:
// the (16,) gate block (Gate only; unread otherwise).
// partials: (gridDim.x, K, kAcc) floats and gsums: (groups, K, kAcc)
// doubles of scratch; tickets: 1 + groups zeroed counters, which the
// finishing blocks reset; out: (K, 44).
template <Cost C, bool Gate>
__global__ void __launch_bounds__(kPairThreads, kBlocksPerSM)
ndt_pair_kernel(const float* __restrict__ params, const float* __restrict__ ptsT,
                const float* __restrict__ table, const int* __restrict__ rows,
                const float* __restrict__ scovT, const float* __restrict__ gate, int N, int K, int R,
                float* __restrict__ partials, double* __restrict__ gsums,
                unsigned int* __restrict__ tickets, float* __restrict__ out) {
  static_assert(kStages == kPairWarps, "warp s owns ring slot s");
  static_assert(!(Gate && C == kAniso), "the gate is for B1 and B2");
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;
  float* sparams = ring + kRingFloats;
  float* wacc = sparams + 16 * K;
  unsigned char* lead = reinterpret_cast<unsigned char*>(wacc + kPairWarps * K * 32);
  __shared__ __align__(8) uint64_t bars[2 * kStages];  // full[kStages], empty[kStages]
  __shared__ bool is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = (int)gridDim.x;
  const int n_tiles = (N + kTile - 1) / kTile;
  const int my_tiles = (n_tiles - (int)blockIdx.x + nb - 1) / nb;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars[s], 1);  // full: the filling warp's arrive and the bytes
      mbar_init(&bars[kStages + s], min((K + 1) / 2, kPairWarps));  // one arrive per reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp < my_tiles) fill_slot(warp, warp, rows, table, N, R, ring, lead, &bars[warp], lane);
  for (int i = tid; i < 16 * K; i += kPairThreads) sparams[i] = params[i];
  for (int i = tid; i < kPairWarps * K * 32; i += kPairThreads) wacc[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < my_tiles; ++j) {
    const int s = j % kStages;
    // this warp's first pose pair: pair p (poses 2p, 2p + 1) of tile j goes
    // to warp (j + p) mod kPairWarps
    const int p0 = (warp - j % kPairWarps + kPairWarps) % kPairWarps;
    if (2 * p0 < K) {
      const int i = ((int)blockIdx.x + j * nb) * kTile + lane;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f;
      float sc[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) sc[c] = 0.f;
      if (i < N) {
        x0 = ptsT[i];
        x1 = ptsT[(size_t)N + i];
        x2 = ptsT[(size_t)2 * N + i];
        if constexpr (C == kAniso) {
#pragma unroll
          for (int c = 0; c < 9; ++c) sc[c] = scovT[(size_t)c * N + i];
        }
      }
      mbar_wait(&bars[s], (j / kStages) & 1);
      const int ld = lead[s * kTile + lane];
      const bool have = ld != kNoRow;  // a point with a row to read (not the sentinel)
      float row[84];
      unsigned valid = 0u;
      const float4* src = reinterpret_cast<const float4*>(ring + ((size_t)s * kTile + ld) * kPitch);
#pragma unroll
      for (int c = 0; c < 21; ++c) {
        const float4 q = have ? src[c] : make_float4(0.f, 0.f, 0.f, 0.f);
        row[4 * c] = q.x;
        row[4 * c + 1] = q.y;
        row[4 * c + 2] = q.z;
        row[4 * c + 3] = q.w;
      }
      if (have) {
        const float4 f0 = src[21], f1 = src[22];
        valid = (f0.x > 0.5f) | ((f0.y > 0.5f) << 1) | ((f0.z > 0.5f) << 2) |
                ((f0.w > 0.5f) << 3) | ((f1.x > 0.5f) << 4) | ((f1.y > 0.5f) << 5) |
                ((f1.z > 0.5f) << 6);
        if constexpr (Gate) valid = gate_slots(gate, x0, x1, x2, row, valid);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[kStages + s]);  // this warp has its rows
      // a tile none of whose points has a valid slot adds nothing
      if (__any_sync(0xffffffffu, valid != 0u)) {
        float* acc = wacc + warp * K * 32 + lane;
        for (int k = 2 * p0; k < K; k += 2 * kPairWarps) {
          if (k + 1 < K)
            pose_block<C, 2>(sparams + 16 * k, 1, x0, x1, x2, sc, row, valid, have, lane,
                             acc + 32 * k);
          else
            pose_block<C, 1>(sparams + 16 * k, 1, x0, x1, x2, sc, row, valid, have, lane,
                             acc + 32 * k);
        }
      }
    }
    if (warp == s && j + kStages < my_tiles) {
      mbar_wait(&bars[kStages + s], (j / kStages) & 1);  // every reader has its rows
      fill_slot(j + kStages, s, rows, table, N, R, ring, lead, &bars[s], lane);
    }
  }
  __syncthreads();

  // this block's partial of each pose: its warps' sums in warp order
  const size_t stride = (size_t)K * kAcc;
  float* part = partials + (size_t)blockIdx.x * stride;
  for (int i = tid; i < K * kAcc; i += kPairThreads) {
    const int k = i / kAcc, c = i % kAcc;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kPairWarps; ++w) a += wacc[(w * K + k) * 32 + c];
    part[i] = a;
  }
  // the last block of each group of kGroup blocks sums the group's
  // partials in block order; the last of those sums the groups in order
  const int g = (int)blockIdx.x / kGroup, g0 = g * kGroup, gn = min(kGroup, nb - g0);
  const int ng = (nb + kGroup - 1) / kGroup;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[1 + g], 1u) == (unsigned)(gn - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  ordered_sums(partials + g0 * stride, stride, gn, K * kAcc, tid, gsums + g * stride);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    tickets[1 + g] = 0u;
    is_last = atomicAdd(&tickets[0], 1u) == (unsigned)(ng - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  double* tot = reinterpret_cast<double*>(ring);  // the ring is free now
  ordered_sums(gsums, stride, ng, K * kAcc, tid, tot);
  __syncthreads();
  for (int i = tid; i < K * kOut; i += kPairThreads) {
    const int k = i / kOut;
    out[i] = (float)rotate_output(tot + k * kAcc, sparams + 16 * k, i % kOut);
  }
  if (tid == 0) tickets[0] = 0u;
}

// Lets the kernel take `smem` bytes of dynamic shared memory, with the SM's
// unified L1 / shared memory split all to shared memory (kBlocksPerSM
// blocks of ~59 KB at K = 20). Done once per size.
template <Cost C, bool Gate>
cudaError_t grant_smem(size_t smem) {
  static size_t smem_set = 0;  // the largest dynamic shared memory granted so far
  if (smem <= smem_set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(ndt_pair_kernel<C, Gate>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ndt_pair_kernel<C, Gate>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) smem_set = smem;
  return e;
}

template <Cost C, bool Gate = false>
int pair_launch(const float* params, const float* ptsT, const float* table, const int* rows,
                const float* scovT, const float* gate, int N, int K, int R, int grid,
                float* partials, double* gsums, unsigned int* tickets, float* out,
                cudaStream_t st) {
  if (K <= 0) return 0;
  if (K > kMaxPoses || R <= 0) return (int)cudaErrorInvalidValue;
  if (N <= 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * K * kOut, st);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = pair_smem_bytes(K);
  const cudaError_t e = grant_smem<C, Gate>(smem);
  if (e != cudaSuccess) return (int)e;
  ndt_pair_kernel<C, Gate><<<grid, kPairThreads, smem, st>>>(
      params, ptsT, table, rows, scovT, gate, N, K, R, partials, gsums, tickets, out);
  return (int)cudaGetLastError();
}

template <Cost C, bool Gate = false>
int blocks_per_sm(int K) {
  const size_t smem = pair_smem_bytes(K);
  int n = 0;
  if (grant_smem<C, Gate>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ndt_pair_kernel<C, Gate>, kPairThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

int ndt_pair_max_poses() { return kMaxPoses; }

int ndt_pair_acc() { return kAcc; }

int ndt_pair_group() { return kGroup; }

// Persistent grid of the pair kernel for N points on `device`: the tile
// count, capped at kBlocksPerSM blocks per SM (independent of K and of the
// cost). 0 on error.
int ndt_pair_grid(int N, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  const int n_tiles = (N + kTile - 1) / kTile;
  return n_tiles < kBlocksPerSM * sms ? n_tiles : kBlocksPerSM * sms;
}

// Blocks of the kernel of `cost` (0 B1, 1 B2, 2 B3; 3 gated B1, 4 gated
// B2) one SM holds at K poses; -1 on error.
int ndt_pair_blocks_per_sm(int K, int cost) {
  switch (cost) {
    case 0: return blocks_per_sm<kNdt>(K);
    case 1: return blocks_per_sm<kGicp>(K);
    case 2: return blocks_per_sm<kAniso>(K);
    case 3: return blocks_per_sm<kNdt, true>(K);
    case 4: return blocks_per_sm<kGicp, true>(K);
    default: return -1;
  }
}

const char* ndt_pair_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// table: (R, 96) rows, 16-byte aligned; rows: (N,) int32 indices into it
// (out of range -> row R - 1); grid: ndt_pair_grid(N); partials: (grid, K, 29) floats and
// gsums: (ceil(grid / group), K, 29) doubles of scratch; tickets:
// 1 + ceil(grid / group) zeroed counters owned by this stream; out: (K, 44).
int ndt_pair_launch(const float* params, const float* ptsT, const float* table, const int* rows,
                    int N, int K, int R, int grid, float* partials, double* gsums,
                    unsigned int* tickets, float* out, void* stream) {
  return pair_launch<kNdt>(params, ptsT, table, rows, nullptr, nullptr, N, K, R, grid, partials,
                           gsums, tickets, out, (cudaStream_t)stream);
}

int gicp_pair_launch(const float* params, const float* ptsT, const float* table, const int* rows,
                     int N, int K, int R, int grid, float* partials, double* gsums,
                     unsigned int* tickets, float* out, void* stream) {
  return pair_launch<kGicp>(params, ptsT, table, rows, nullptr, nullptr, N, K, R, grid, partials,
                            gsums, tickets, out, (cudaStream_t)stream);
}

// As ndt_pair_launch and gicp_pair_launch, with the KDTREE gate: gate is
// the (16,) block R_g (9), t_g (3), r^2, pad, 16-byte aligned.
int ndt_pair_gated_launch(const float* params, const float* ptsT, const float* table,
                          const int* rows, const float* gate, int N, int K, int R, int grid,
                          float* partials, double* gsums, unsigned int* tickets, float* out,
                          void* stream) {
  return pair_launch<kNdt, true>(params, ptsT, table, rows, nullptr, gate, N, K, R, grid, partials,
                                 gsums, tickets, out, (cudaStream_t)stream);
}

int gicp_pair_gated_launch(const float* params, const float* ptsT, const float* table,
                           const int* rows, const float* gate, int N, int K, int R, int grid,
                           float* partials, double* gsums, unsigned int* tickets, float* out,
                           void* stream) {
  return pair_launch<kGicp, true>(params, ptsT, table, rows, nullptr, gate, N, K, R, grid,
                                  partials, gsums, tickets, out, (cudaStream_t)stream);
}

// As ndt_pair_launch, over the aux table, with scovT: (9, N) source
// covariances, planar.
int aniso_pair_launch(const float* params, const float* ptsT, const float* table, const int* rows,
                      const float* scovT, int N, int K, int R, int grid, float* partials,
                      double* gsums, unsigned int* tickets, float* out, void* stream) {
  return pair_launch<kAniso>(params, ptsT, table, rows, scovT, nullptr, N, K, R, grid, partials,
                             gsums, tickets, out, (cudaStream_t)stream);
}

}  // extern "C"
