// The whole Levenberg-Marquardt solve of one pyramid level in one launch,
// for Hopper (sm_90a).
//
// The evaluation inside it replaces the Pallas TPU kernel `_kernel` of
// visual_odometry_rs_tpu/ops/pallas/residual_kernel.py; the loop around it
// is what the JAX package compiles into one device program with
// lax.while_loop (models/tracker.py::solve_level and
// solve_level_brightness, math/optimizer.py).
//
// What bounds it on this card.  Not bytes and not arithmetic: a level is at
// most 8192 candidates of 41 bytes and a u8 image that stays in L2.  A
// solve of 4-20 evaluations run from the host costs a launch, a second
// launch for the cross-block sum, some 200 tiny launches of 6x6 algebra and
// one device->host read PER EVALUATION, all of them latency.
//
// What the design does about it.
// - One persistent launch per level: evaluation, reduction, damped
//   Cholesky solve, se3 exp, inverse-compositional update, first-order
//   renormalisation, finiteness check and the accept/reject/lambda rule all
//   run here, so the host neither launches nor reads anything per iteration.
// - Candidate data is read from global memory once per level: every thread
//   keeps its candidates (back-projected point, template value, Jacobian
//   row) in registers across all evaluations; only the image taps change,
//   and they come from L2.
// - The cross-block sum goes through distributed shared memory of a thread
//   block cluster, in rank order (residual_eval.cuh): no second launch, no
//   float atomic, the same bits in every run.
// - Thread 0 of EVERY block does the scalar step, from the same sums in the
//   same order, so all blocks take the same branch without a broadcast.
// - Input and output stay on the device: the start pose comes from the
//   previous level's record, and the rule "after a failed level the pose is
//   frozen" (inverse_compositional.rs:195-199) is applied here, so a frame
//   is six launches chained through one buffer.
// - A lane axis for the batched tracker: the grid is one cluster per lane
//   (blockIdx.y), and each lane offsets its pointers to its own image,
//   candidates, state, record and flow candidates.  Lanes share nothing and
//   never wait on each other: each cluster ends when its own solve ends,
//   where the JAX package's vmap of a while_loop runs every lane for as
//   many iterations as the slowest.  One lane is exactly the launch of
//   one level of one sequence.  An optional image index per lane lets
//   several lanes read one image (relocalization solves one frame against
//   K keyframes); an optional active flag per lane turns a lane into a
//   pass-through that returns at once, so a recovery that only some lanes
//   need is launched without the host reading which.
//
// The tracker's options are template parameters (residual_eval.cuh), so the
// plain solve compiles to the code it had before they existed:
// - kRobust: Huber weights in the evaluation (robust_delta);
// - NP = 8: the affine brightness model.  The state is the pose and the
//   gain and bias (a, b); the system is 8x8; a step updates the pose
//   inverse-compositionally with delta[0:6] and adds delta[6:8] to (a, b);
//   (a, b) hand on to the next level with the pose and freeze with it.
//
// Control flow, as math/optimizer.py and models/tracker.py::solve_level:
// evaluate at the start pose with lambda = lm_coef_init; then, counting
// nb_iter from 1: solve the damped system (a non-positive or non-finite
// pivot gives a NaN step), update the pose; a non-finite pose ends the solve
// as failed with the state untouched (its evaluation is skipped); otherwise
// evaluate; new_energy > energy rejects (lambda *= 10, continue); anything
// else, NaN included, accepts (lambda *= 0.1) and continues iff
// old - new > energy_tol; nb_iter > max_iterations stops either way; the
// hard bound is max_iterations + 3.
//
// Record written by block 0 (128 floats; counts are exact small integers).
// Its first kState floats are the next level's state_in:
//   [0:7]    pose handed to the next level: the accepted pose, or the input
//            pose if this or an earlier level failed
//   [7]      1 if this or an earlier level failed, else 0
//   [8:10]   brightness (a, b) handed on, frozen with the pose (the plain
//            solve passes its input through)
//   [10:17]  the accepted pose of this solve   [17:19] its (a, b)
//   [19]     its energy     [20] lambda     [21] nb_iter
//   [22]     evaluations    [23] 1 if this solve failed
//   [24:24+NP(NP+1)] [H | g] at the accepted state, NP x (NP+1) row-major
//            (6x7 in [24:66], 8x9 in [24:96])
//   [96]     mean optical flow |du| + |dv| of the `flow` candidates under the
//            pose handed on (the keyframe criterion of
//            inverse_compositional.rs:211-222; the tracker asks for it in the
//            finest level's launch), 0 when none are given
//   [97:100] the lost-frame detector, when asked for: the plain energy
//            sum r^2 / count of this level's candidates under the pose
//            handed on (unweighted, no brightness: the JAX package's
//            _eval_energy), its inside count and the count of valid
//            candidates; 0 otherwise
//   [100:105] clock cycles seen by thread 0 of block 0: loading the
//            candidates; then summed over the evaluations: the candidates'
//            sums, the reduction, the scalar step; and the whole kernel.  The
//            tools that a kernel's inside is usually read with do not run
//            everywhere; these five clock reads per iteration always do.
// An inactive lane writes [0:10] and the accepted state from its state_in,
// NaN energies and flow, and zero counts.

#include "residual_eval.cuh"

#include <math.h>

namespace {

using namespace vors;

constexpr int kRecord = 128;
constexpr int kState = 10;
constexpr int kAccepted = 10, kEnergy = 19, kNormal = 24, kFlow = 96, kDetector = 97,
              kCycles = 100;

// The candidates whose mean optical flow the launch reports: the tracker's
// coarsest level.
struct FlowLevel {
  const float *xs, *ys, *idepth;
  const uint8_t* valid;
  const float* intrinsics;
  int n;
};

template <int NP>
struct LMState {
  Motion model;
  float ab[2];
  float energy;
  float h[tri_size(NP)];  // upper triangle
  float g[NP];
  float lm;
};

// Solves (H with its diagonal scaled by 1 + lm) delta = g by Cholesky.
// A pivot that is not positive and finite makes the whole delta NaN.
// One division per column: the column and both substitutions multiply by
// the reciprocal of the diagonal entry, because a division is a long
// dependent chain and this thread runs alone.
template <int NP>
__device__ void damped_solve(const float (&h)[tri_size(NP)], const float (&g)[NP], float lm,
                             float (&delta)[NP]) {
  float l[NP][NP];
  float inv[NP];  // 1 / l[j][j]
  bool ok = true;
  const float damp = 1.0f + lm;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float d = h[upper_index<NP>(j, j)] * damp;
#pragma unroll
    for (int k = 0; k < j; ++k) d -= l[j][k] * l[j][k];
    ok = ok && d > 0.0f && d < INFINITY;
    inv[j] = 1.0f / sqrtf(d);
#pragma unroll
    for (int i = j + 1; i < NP; ++i) {
      float v = h[upper_index<NP>(j, i)];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= l[i][k] * l[j][k];
      l[i][j] = v * inv[j];
    }
  }
  float y[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    float v = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= l[i][k] * y[k];
    y[i] = v * inv[i];
  }
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < NP; ++k) v -= l[k][i] * delta[k];
    delta[i] = v * inv[i];
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < NP; ++i) delta[i] = NAN;
  }
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// v + w (2 u x v) + u x (2 u x v), the form math/pose.py::quat_rotate uses
__device__ __forceinline__ Vec3 quat_rotate(float w, const Vec3& u, const Vec3& v) {
  const Vec3 c = cross(u, v);
  const Vec3 tv = {2.0f * c.x, 2.0f * c.y, 2.0f * c.z};
  const Vec3 utv = cross(u, tv);
  return {v.x + w * tv.x + utv.x, v.y + w * tv.y + utv.y, v.z + w * tv.z + utv.z};
}

// se3 exp of the twist [v, w] = xi[0:6] (math/se3.py::exp), Taylor below
// theta^2 < 1e-4.
template <int N>
__device__ Motion se3_exp(const float (&xi)[N]) {
  const float vx = xi[0], vy = xi[1], vz = xi[2];
  const float wx = xi[3], wy = xi[4], wz = xi[5];
  const float theta_2 = wx * wx + wy * wy + wz * wz;
  float real, imag, c1, c2;
  if (theta_2 < 1e-4f) {
    real = 1.0f - 0.125f * theta_2;
    imag = 0.5f - (1.0f / 48.0f) * theta_2;
    c1 = 0.5f - (1.0f / 24.0f) * theta_2;
    c2 = (1.0f / 6.0f) - (1.0f / 120.0f) * theta_2;
  } else {  // also taken for a NaN step, which it passes on
    const float theta = sqrtf(theta_2);
    float sin_half, sin_theta, cos_theta;
    sincosf(0.5f * theta, &sin_half, &real);
    sincosf(theta, &sin_theta, &cos_theta);
    imag = sin_half / theta;
    c1 = (1.0f - cos_theta) / theta_2;
    c2 = (theta - sin_theta) / (theta * theta_2);
  }
  // V = I + c1 hat(w) + c2 hat(w)^2, t = V v
  const float w11 = wx * wx, w22 = wy * wy, w33 = wz * wz;
  const float w12 = wx * wy, w13 = wx * wz, w23 = wy * wz;
  const float v00 = 1.0f + c2 * (-w22 - w33), v01 = c1 * -wz + c2 * w12, v02 = c1 * wy + c2 * w13;
  const float v10 = c1 * wz + c2 * w12, v11 = 1.0f + c2 * (-w11 - w33), v12 = c1 * -wx + c2 * w23;
  const float v20 = c1 * -wy + c2 * w13, v21 = c1 * wx + c2 * w23, v22 = 1.0f + c2 * (-w11 - w22);
  Motion m;
  m.tx = v00 * vx + v01 * vy + v02 * vz;
  m.ty = v10 * vx + v11 * vy + v12 * vz;
  m.tz = v20 * vx + v21 * vy + v22 * vz;
  const float qx = imag * wx, qy = imag * wy, qz = imag * wz;
  const float norm = sqrtf(real * real + qx * qx + qy * qy + qz * qz);
  m.qw = real / norm;
  m.qx = qx / norm;
  m.qy = qy / norm;
  m.qz = qz / norm;
  return m;
}

// renormalize_first_order(compose(model, inverse(exp(delta[0:6])))): the
// inverse-compositional update (lm_optimizer.rs:195-209).
template <int N>
__device__ Motion lm_step(const Motion& model, const float (&delta)[N]) {
  const Motion e = se3_exp(delta);
  // inverse of e
  const Vec3 ui = {-e.qx, -e.qy, -e.qz};
  const Vec3 r = quat_rotate(e.qw, ui, {e.tx, e.ty, e.tz});
  const Vec3 ti = {-r.x, -r.y, -r.z};
  // compose: Hamilton product and model.t + R(model.q) ti
  const float w1 = model.qw, x1 = model.qx, y1 = model.qy, z1 = model.qz;
  const float w2 = e.qw, x2 = ui.x, y2 = ui.y, z2 = ui.z;
  float qw = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  float qx = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  float qy = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  float qz = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  const Vec3 rt = quat_rotate(w1, {x1, y1, z1}, ti);
  // q' = 0.5 (3 - |q|^2) q
  const float f = 0.5f * (3.0f - (qw * qw + qx * qx + qy * qy + qz * qz));
  return {f * qw, f * qx, f * qy, f * qz, model.tx + rt.x, model.ty + rt.y, model.tz + rt.z};
}

__device__ __forceinline__ bool all_finite(const Motion& m) {
  return isfinite(m.qw) && isfinite(m.qx) && isfinite(m.qy) && isfinite(m.qz) &&
         isfinite(m.tx) && isfinite(m.ty) && isfinite(m.tz);
}

__device__ __forceinline__ void store_motion(float* dst, const Motion& m) {
  dst[0] = m.qw; dst[1] = m.qx; dst[2] = m.qy; dst[3] = m.qz;
  dst[4] = m.tx; dst[5] = m.ty; dst[6] = m.tz;
}

__device__ __forceinline__ Motion load_motion(const float* src) {
  return {src[0], src[1], src[2], src[3], src[4], src[5], src[6]};
}

template <int NP>
__device__ void write_record(float* record, const Motion& handed_on, const float (&handed_ab)[2],
                             bool frozen, const LMState<NP>& state, int nb_iter, int nb_evals,
                             bool failed, float flow, const float (&detector)[3],
                             const unsigned (&cycles)[5]) {
  store_motion(record, handed_on);
  record[7] = frozen ? 1.0f : 0.0f;
  record[8] = handed_ab[0];
  record[9] = handed_ab[1];
  store_motion(record + kAccepted, state.model);
  record[kAccepted + 7] = state.ab[0];
  record[kAccepted + 8] = state.ab[1];
  record[kEnergy] = state.energy;
  record[kEnergy + 1] = state.lm;
  record[kEnergy + 2] = (float)nb_iter;
  record[kEnergy + 3] = (float)nb_evals;
  record[kEnergy + 4] = failed ? 1.0f : 0.0f;
#pragma unroll
  for (int row = 0; row < NP; ++row) {
#pragma unroll
    for (int col = 0; col < NP; ++col) {
      record[kNormal + (NP + 1) * row + col] =
          state.h[row < col ? upper_index<NP>(row, col) : upper_index<NP>(col, row)];
    }
    record[kNormal + (NP + 1) * row + NP] = state.g[row];
  }
#pragma unroll
  for (int t = kNormal + NP * (NP + 1); t < kFlow; ++t) record[t] = 0.0f;
  record[kFlow] = flow;
#pragma unroll
  for (int t = 0; t < 3; ++t) record[kDetector + t] = detector[t];
#pragma unroll
  for (int t = 0; t < 5; ++t) record[kCycles + t] = (float)cycles[t];
#pragma unroll
  for (int t = kCycles + 5; t < kRecord; ++t) record[t] = 0.0f;
}

// The record of a lane that does not run: its input handed on unchanged.
__device__ void write_passthrough(float* record, const float* state_in) {
#pragma unroll
  for (int t = 0; t < kState; ++t) record[t] = state_in[t];
#pragma unroll
  for (int t = 0; t < 7; ++t) record[kAccepted + t] = state_in[t];
  record[kAccepted + 7] = state_in[8];
  record[kAccepted + 8] = state_in[9];
  record[kEnergy] = NAN;
#pragma unroll
  for (int t = kEnergy + 1; t < kFlow; ++t) record[t] = 0.0f;
  record[kFlow] = NAN;
  record[kDetector] = NAN;
#pragma unroll
  for (int t = kDetector + 1; t < kRecord; ++t) record[t] = 0.0f;
}

// Adds `x` over the block (shuffles, then the warps in index order), for
// one block in a fixed order; every thread gets the sums.  The caller has
// passed a __syncthreads() since the last use of sh.warp_sums.
template <int N, int S>
__device__ __forceinline__ void block_sum(float (&x)[N], ReduceShared<S>& sh) {
  static_assert(N <= S, "the warp sums hold N values");
#pragma unroll
  for (int t = 0; t < N; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x[t] += __shfl_down_sync(0xffffffffu, x[t], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int t = 0; t < N; ++t) sh.warp_sums[threadIdx.x >> 5][t] = x[t];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < N; ++t) {
    x[t] = 0.0f;
    for (int w = 0; w < kWarps; ++w) x[t] += sh.warp_sums[w][t];
  }
}

// sum over the valid flow candidates of |x - u| + |y - v|, / sum(valid), by
// one block in a fixed order.  A padding candidate (idepth 0) warps to NaN
// and is left out, as the JAX package's jitted trackers leave it out (XLA
// compiles its sum(dflow * valid) into a select); a level without a valid
// candidate reports 0 / 0, NaN, which never triggers a keyframe switch.
template <int S>
__device__ float mean_flow(const FlowLevel& fl, const Motion& m, ReduceShared<S>& sh) {
  const Camera k = {fl.intrinsics[0], fl.intrinsics[1], fl.intrinsics[2], fl.intrinsics[3],
                    fl.intrinsics[4]};
  float sums[2] = {0.0f, 0.0f};  // flow, count
  for (int i = threadIdx.x; i < fl.n; i += kThreads) {
    const float x = fl.xs[i], y = fl.ys[i];
    const float depth = 1.0f / fl.idepth[i];
    const float py = (y - k.cy) * depth / k.fy;
    const float px = ((x - k.cx) * depth - k.skew * py) / k.fx;
    float u, v;
    warp_point(px, py, depth, m, k, u, v);
    if (fl.valid[i] != 0) {
      sums[0] += fabsf(x - u) + fabsf(y - v);
      sums[1] += 1.0f;
    }
  }
  block_sum(sums, sh);
  return sums[0] / sums[1];
}

// The lost-frame detector: the plain energy of the level under `m` (sum of
// r^2 over the inside candidates / their count, NaN when none is inside),
// the inside count and the valid count, by one block in a fixed order.
template <int S>
__device__ void detector_sums(const Level& lv, const Camera& k, const Motion& m,
                              ReduceShared<S>& sh, float (&out)[3]) {
  float sums[3] = {0.0f, 0.0f, 0.0f};  // sum r^2, inside, valid
  for (int i = threadIdx.x; i < lv.n; i += kThreads) {
    const Candidate c = load_candidate(lv, k, i);
    if (!c.valid) continue;
    sums[2] += 1.0f;
    float val;
    if (sample(c, m, k, lv, val)) {
      const float r = val - c.tmpl;
      sums[0] += r * r;
      sums[1] += 1.0f;
    }
  }
  __syncthreads();  // the flow's reads of the warp sums are done
  block_sum(sums, sh);
  out[0] = sums[0] / sums[1];
  out[1] = sums[1];
  out[2] = sums[2];
}

// Moves the pointers of `lv` and `flow` to lane `lane`, whose image is
// image `image` of the launch: lanes are laid out one after another,
// (images, h, w) images and (lanes, n, ...) candidates.
__device__ __forceinline__ void to_lane(int lane, int image, Level& lv, FlowLevel& flow) {
  const size_t n = (size_t)lane * lv.n;
  lv.img += (size_t)image * lv.height * lv.width;
  lv.xs += n;
  lv.ys += n;
  lv.idepth += n;
  lv.tmpl += n;
  lv.valid += n;
  lv.jac += 6 * n;
  const size_t fn = (size_t)lane * flow.n;
  flow.xs += fn;
  flow.ys += fn;
  flow.idepth += fn;
  flow.valid += fn;
}

template <int NP, bool kRobust>
__global__ void __launch_bounds__(kThreads)
lm_solve_level_kernel(Level lv, const float* __restrict__ intrinsics,
                      const float* __restrict__ state_in, int state_stride, float lm_coef_init,
                      int max_iterations, float energy_tol, float robust_delta,
                      FlowLevel flow_level, int detector, const int* __restrict__ image_index,
                      const uint8_t* __restrict__ active, float* __restrict__ record) {
  constexpr int S = sum_count(NP);
  constexpr int kTri = tri_size(NP);
  // a lane's state is `state_stride` floats after the previous lane's
  const int lane = blockIdx.y;
  to_lane(lane, image_index != nullptr ? image_index[lane] : lane, lv, flow_level);
  state_in += (size_t)lane * state_stride;
  record += (size_t)lane * kRecord;
  if (active != nullptr && active[lane] == 0) {  // the whole cluster leaves together
    if (blockIdx.x == 0 && threadIdx.x == 0) write_passthrough(record, state_in);
    return;
  }
  __shared__ ReduceShared<S> sh;
  __shared__ float sh_pose[9];  // the pose and (a, b) to evaluate next
  __shared__ int sh_go;         // 1: evaluate sh_pose, 0: the solve has ended
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nranks = (int)cluster.num_blocks();
  const bool scalar_thread = threadIdx.x == 0;

  const unsigned t_start = clock();
  unsigned cycles[5] = {0, 0, 0, 0, 0};  // load, sums, reduce, scalar, kernel
  const Camera k = {intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3], intrinsics[4]};
  Candidate cache[cached_count(NP, kRobust)];
  load_cached(lv, k, rank, nranks, cache);
  cycles[0] = clock() - t_start;

  // the scalar state lives in thread 0 of every block
  LMState<NP> state;
  Motion candidate = load_motion(state_in);
  float candidate_ab[2] = {state_in[8], state_in[9]};
  const Motion model_in = candidate;
  const float ab_in[2] = {candidate_ab[0], candidate_ab[1]};
  const bool failed_in = state_in[7] != 0.0f;
  int nb_iter = 0, nb_evals = 0;
  bool failed = false;
  if (scalar_thread) {
    store_motion(sh_pose, candidate);
    sh_pose[7] = candidate_ab[0];
    sh_pose[8] = candidate_ab[1];
  }
  __syncthreads();

  for (int parity = 0;; parity ^= 1) {
    const unsigned t_eval = clock();
    const Motion m = load_motion(sh_pose);
    const Photometric ph = {sh_pose[7], sh_pose[8], robust_delta};
    float s[S];
    thread_sums<NP, kRobust>(lv, k, m, ph, cache, rank, nranks, s);
    const unsigned t_sums = clock();
    cluster_reduce(s, sh, parity, cluster);
    const unsigned t_reduced = clock();
    cycles[1] += t_sums - t_eval;
    cycles[2] += t_reduced - t_sums;

    if (scalar_thread) {
      const float new_energy = sh.total[kTri + NP] / sh.total[kTri + NP + 1];  // NaN when nothing is inside
      bool accept = true, cont = true;
      if (nb_evals == 0) {
        state.lm = lm_coef_init;
      } else {
        const bool rejected = new_energy > state.energy;  // false for NaN: accepted
        accept = !rejected;
        cont = nb_iter <= max_iterations &&
               (rejected || state.energy - new_energy > energy_tol);
        state.lm *= rejected ? 10.0f : 0.1f;
      }
      ++nb_evals;
      if (accept) {
        state.model = candidate;
        state.ab[0] = candidate_ab[0];
        state.ab[1] = candidate_ab[1];
        state.energy = new_energy;
#pragma unroll
        for (int t = 0; t < kTri; ++t) state.h[t] = sh.total[t];
#pragma unroll
        for (int t = 0; t < NP; ++t) state.g[t] = sh.total[kTri + t];
      }
      int go = 0;
      if (cont && nb_iter < max_iterations + 3) {
        ++nb_iter;
        float delta[NP];
        damped_solve<NP>(state.h, state.g, state.lm, delta);
        candidate = lm_step(state.model, delta);
        bool finite = all_finite(candidate);
        if constexpr (NP == 8) {
          candidate_ab[0] = state.ab[0] + delta[6];
          candidate_ab[1] = state.ab[1] + delta[7];
          finite = finite && isfinite(candidate_ab[0]) && isfinite(candidate_ab[1]);
        }
        if (finite) {
          store_motion(sh_pose, candidate);
          sh_pose[7] = candidate_ab[0];
          sh_pose[8] = candidate_ab[1];
          go = 1;
        } else {
          failed = true;
        }
      }
      sh_go = go;
      cycles[3] += clock() - t_reduced;
    }
    __syncthreads();
    if (!sh_go) break;
  }

  if (rank == 0) {
    // the pose handed on, known to thread 0, goes to the block for the flow
    const bool frozen = failed_in || failed;
    if (scalar_thread) {
      store_motion(sh_pose, frozen ? model_in : state.model);
      sh_pose[7] = frozen ? ab_in[0] : state.ab[0];
      sh_pose[8] = frozen ? ab_in[1] : state.ab[1];
    }
    __syncthreads();
    const Motion handed_on = load_motion(sh_pose);
    const float handed_ab[2] = {sh_pose[7], sh_pose[8]};
    const float flow = flow_level.n > 0 ? mean_flow(flow_level, handed_on, sh) : 0.0f;
    float det[3] = {0.0f, 0.0f, 0.0f};
    if (detector) detector_sums(lv, k, handed_on, sh, det);
    if (scalar_thread) {
      cycles[4] = clock() - t_start;
      write_record(record, handed_on, handed_ab, frozen, state, nb_iter, nb_evals, failed, flow,
                   det, cycles);
    }
  }
  cluster.sync();  // no block leaves while its sums may still be read
}

struct SolveArgs {
  Level lv;
  const float* intrinsics;
  const float* state_in;
  int state_stride;
  float lm_coef_init;
  int max_iterations;
  float energy_tol;
  float robust_delta;
  FlowLevel flow;
  int detector;
  const int* image_index;
  const uint8_t* active;
  float* record;
};

template <int NP, bool kRobust>
cudaError_t launch(const SolveArgs& a, int cluster, int lanes, cudaStream_t stream) {
  return launch_cluster(lm_solve_level_kernel<NP, kRobust>, cluster, lanes, stream, a.lv,
                        a.intrinsics, a.state_in, a.state_stride, a.lm_coef_init,
                        a.max_iterations, a.energy_tol, a.robust_delta, a.flow, a.detector,
                        a.image_index, a.active, a.record);
}

// The instantiation for the options: `fn` called with the kernel.
template <typename Fn>
int with_kernel(int brightness, int robust, Fn fn) {
  if (brightness) {
    return robust ? fn(lm_solve_level_kernel<8, true>) : fn(lm_solve_level_kernel<8, false>);
  }
  return robust ? fn(lm_solve_level_kernel<6, true>) : fn(lm_solve_level_kernel<6, false>);
}

}  // namespace

extern "C" {

int vors_lm_record_size() { return kRecord; }
int vors_lm_state_size() { return kState; }

// One launch on `stream` as `lanes` clusters of `cluster` (1, 2, 4 or 8)
// blocks, one cluster per lane: the LM solve of one level of every lane from
// the state in its `state_in` (10 floats: pose, failed-so-far flag, (a, b);
// lane b's at state_in + b * state_stride) into its `record` (128 floats,
// lane after lane).  robust_delta > 0: Huber weights; brightness != 0: the
// 8-parameter solve over the pose and (a, b).  With flow_n > 0 also the mean
// optical flow of the lane's flow candidates; with detector != 0 the plain
// energy, inside and valid counts of the level under the pose handed on.
// Candidates and flow candidates are laid out lane after lane; lane b reads
// image image_index[b] (b when image_index is null) of the (images, h, w)
// array; a lane whose active[b] is 0 only passes its state through (all
// lanes run when active is null); the intrinsics are shared.  Returns the
// CUDA error of the launch (0 = success).
int vors_lm_solve_level(const void* img, int height, int width, const void* xs, const void* ys,
                        const void* idepth, const void* tmpl, const void* valid,
                        const void* jac, int n, const void* intrinsics, const void* state_in,
                        int state_stride, float lm_coef_init, int max_iterations,
                        float energy_tol, float robust_delta, int brightness,
                        const void* flow_xs, const void* flow_ys, const void* flow_idepth,
                        const void* flow_valid, const void* flow_intrinsics, int flow_n,
                        int detector, const void* image_index, const void* active,
                        void* record, int cluster, int lanes, void* stream) {
  SolveArgs a;
  a.lv = {static_cast<const uint8_t*>(img), height, width,
          static_cast<const float*>(xs), static_cast<const float*>(ys),
          static_cast<const float*>(idepth), static_cast<const float*>(tmpl),
          static_cast<const uint8_t*>(valid), static_cast<const float*>(jac), n};
  a.intrinsics = static_cast<const float*>(intrinsics);
  a.state_in = static_cast<const float*>(state_in);
  a.state_stride = state_stride;
  a.lm_coef_init = lm_coef_init;
  a.max_iterations = max_iterations;
  a.energy_tol = energy_tol;
  a.robust_delta = robust_delta;
  a.flow = {static_cast<const float*>(flow_xs), static_cast<const float*>(flow_ys),
            static_cast<const float*>(flow_idepth), static_cast<const uint8_t*>(flow_valid),
            static_cast<const float*>(flow_intrinsics), flow_n};
  a.detector = detector;
  a.image_index = static_cast<const int*>(image_index);
  a.active = static_cast<const uint8_t*>(active);
  a.record = static_cast<float*>(record);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool robust = robust_delta > 0.0f;
  cudaError_t err;
  if (brightness) {
    err = robust ? launch<8, true>(a, cluster, lanes, s) : launch<8, false>(a, cluster, lanes, s);
  } else {
    err = robust ? launch<6, true>(a, cluster, lanes, s) : launch<6, false>(a, cluster, lanes, s);
  }
  return static_cast<int>(err);
}

// How many clusters of `cluster` blocks of the instantiation for the options
// the card holds at once (cudaOccupancyMaxActiveClusters), into *count;
// returns the CUDA error.
int vors_lm_max_active_clusters(int cluster, int brightness, int robust, int* count) {
  if (!valid_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  return with_kernel(brightness, robust, [&](auto kernel) {
    cudaLaunchAttribute attribute;
    const cudaLaunchConfig_t config = cluster_config(cluster, 1, nullptr, attribute);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(count, kernel, &config));
  });
}

// Registers and local bytes of one instantiation into regs[0], regs[1].
int vors_lm_solve_resources(int brightness, int robust, int* regs) {
  return with_kernel(brightness, robust, [&](auto kernel) { return kernel_resources(kernel, regs); });
}

}  // extern "C"
