// The whole Levenberg-Marquardt solve of one pyramid level in one launch,
// for Hopper (sm_90a).
//
// The evaluation inside it replaces the Pallas TPU kernel `_kernel` of
// visual_odometry_rs_tpu/ops/pallas/residual_kernel.py; the loop around it
// is what the JAX package compiles into one device program with
// lax.while_loop (models/tracker.py::solve_level, math/optimizer.py).
//
// What bounds it on this card.  Not bytes and not arithmetic: a level is at
// most 8192 candidates of 41 bytes and a u8 image that stays in L2.  A
// solve of 4-20 evaluations run from the host costs a launch, a second
// launch for the cross-block sum, some 200 tiny launches of 6x6 algebra and
// one device->host read PER EVALUATION, all of them latency.
//
// What the design does about it.
// - One persistent launch per level: evaluation, reduction, damped 6x6
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
//   one level of one sequence.
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
// Record written by block 0 (72 floats; counts are exact small integers):
//   [0:7]   pose handed to the next level: the accepted pose, or the input
//           pose if this or an earlier level failed
//   [7]     1 if this or an earlier level failed, else 0
//   [8:15]  the accepted pose of this solve
//   [15]    its energy     [16] lambda     [17] nb_iter
//   [18]    evaluations    [19] 1 if this solve failed
//   [20:62] [H | g] at the accepted pose, 6x7 row-major
//   [62]    mean optical flow |du| + |dv| of the `flow` candidates under the
//           pose handed on (the keyframe criterion of
//           inverse_compositional.rs:211-222; the tracker asks for it in the
//           finest level's launch), 0 when none are given
//   [64:69] clock cycles seen by thread 0 of block 0: loading the candidates;
//           then summed over the evaluations: the candidates' sums, the
//           reduction, the scalar step; and the whole kernel.  The tools that
//           a kernel's inside is usually read with do not run everywhere;
//           these five clock reads per iteration always do.

#include "residual_eval.cuh"

#include <math.h>

namespace {

using namespace vors;

constexpr int kRecord = 72;

// The candidates whose mean optical flow the launch reports: the tracker's
// coarsest level.
struct FlowLevel {
  const float *xs, *ys, *idepth;
  const uint8_t* valid;
  const float* intrinsics;
  int n;
};

struct LMState {
  Motion model;
  float energy;
  float h[21];  // upper triangle
  float g[6];
  float lm;
};

// Solves (H with its diagonal scaled by 1 + lm) delta = g by Cholesky.
// A pivot that is not positive and finite makes the whole delta NaN.
// One division per column: the column and both substitutions multiply by
// the reciprocal of the diagonal entry, because a division is a long
// dependent chain and this thread runs alone.
__device__ void damped_solve(const float (&h)[21], const float (&g)[6], float lm,
                             float (&delta)[6]) {
  float l[6][6];
  float inv[6];  // 1 / l[j][j]
  bool ok = true;
  const float damp = 1.0f + lm;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = h[upper_index(j, j)] * damp;
#pragma unroll
    for (int k = 0; k < j; ++k) d -= l[j][k] * l[j][k];
    ok = ok && d > 0.0f && d < INFINITY;
    inv[j] = 1.0f / sqrtf(d);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = h[upper_index(j, i)];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= l[i][k] * l[j][k];
      l[i][j] = v * inv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= l[i][k] * y[k];
    y[i] = v * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v -= l[k][i] * delta[k];
    delta[i] = v * inv[i];
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) delta[i] = NAN;
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

// se3 exp of the twist [v, w] (math/se3.py::exp), Taylor below theta^2 < 1e-4.
__device__ Motion se3_exp(const float (&xi)[6]) {
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

// renormalize_first_order(compose(model, inverse(exp(delta)))): the
// inverse-compositional update (lm_optimizer.rs:195-209).
__device__ Motion lm_step(const Motion& model, const float (&delta)[6]) {
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

__device__ void write_record(float* record, const Motion& handed_on, bool frozen,
                             const LMState& state, int nb_iter, int nb_evals, bool failed,
                             float flow, const unsigned (&cycles)[5]) {
  store_motion(record, handed_on);
  record[7] = frozen ? 1.0f : 0.0f;
  store_motion(record + 8, state.model);
  record[15] = state.energy;
  record[16] = state.lm;
  record[17] = (float)nb_iter;
  record[18] = (float)nb_evals;
  record[19] = failed ? 1.0f : 0.0f;
#pragma unroll
  for (int row = 0; row < 6; ++row) {
#pragma unroll
    for (int col = 0; col < 6; ++col) {
      record[20 + 7 * row + col] =
          state.h[row < col ? upper_index(row, col) : upper_index(col, row)];
    }
    record[20 + 7 * row + 6] = state.g[row];
  }
  record[62] = flow;
  record[63] = 0.0f;
#pragma unroll
  for (int t = 0; t < 5; ++t) record[64 + t] = (float)cycles[t];
#pragma unroll
  for (int t = 69; t < kRecord; ++t) record[t] = 0.0f;
}

// sum(|x - u| + |y - v|) * valid / sum(valid) over the flow candidates, by
// one block in a fixed order.  A padding candidate (idepth 0) warps to NaN
// and NaN * 0 is NaN, so a level with padding reports NaN, which never
// triggers a keyframe switch: the behaviour of the JAX package, kept.
__device__ float mean_flow(const FlowLevel& fl, const Motion& m, ReduceShared& sh) {
  const Camera k = {fl.intrinsics[0], fl.intrinsics[1], fl.intrinsics[2], fl.intrinsics[3],
                    fl.intrinsics[4]};
  float flow = 0.0f, count = 0.0f;
  for (int i = threadIdx.x; i < fl.n; i += kThreads) {
    const float x = fl.xs[i], y = fl.ys[i];
    const float depth = 1.0f / fl.idepth[i];
    const float py = (y - k.cy) * depth / k.fy;
    const float px = ((x - k.cx) * depth - k.skew * py) / k.fx;
    float u, v;
    warp_point(px, py, depth, m, k, u, v);
    const float validf = fl.valid[i] != 0 ? 1.0f : 0.0f;
    flow += (fabsf(x - u) + fabsf(y - v)) * validf;
    count += validf;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    flow += __shfl_down_sync(0xffffffffu, flow, off);
    count += __shfl_down_sync(0xffffffffu, count, off);
  }
  if ((threadIdx.x & 31) == 0) {
    sh.warp_sums[threadIdx.x >> 5][0] = flow;
    sh.warp_sums[threadIdx.x >> 5][1] = count;
  }
  __syncthreads();
  flow = 0.0f;
  count = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    flow += sh.warp_sums[w][0];
    count += sh.warp_sums[w][1];
  }
  return flow / count;
}

// Moves the pointers of `lv` and `flow` to lane `lane`: lanes are laid out
// one after another, (lanes, h, w) images and (lanes, n, ...) candidates.
__device__ __forceinline__ void to_lane(int lane, Level& lv, FlowLevel& flow) {
  const size_t n = (size_t)lane * lv.n;
  lv.img += (size_t)lane * lv.height * lv.width;
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

__global__ void __launch_bounds__(kThreads)
lm_solve_level_kernel(Level lv, const float* __restrict__ intrinsics,
                      const float* __restrict__ state_in, int state_stride, float lm_coef_init,
                      int max_iterations, float energy_tol, FlowLevel flow_level,
                      float* __restrict__ record) {
  // a lane's state is `state_stride` floats after the previous lane's
  to_lane(blockIdx.y, lv, flow_level);
  state_in += (size_t)blockIdx.y * state_stride;
  record += (size_t)blockIdx.y * kRecord;
  __shared__ ReduceShared sh;
  __shared__ float sh_pose[7];  // the pose to evaluate next
  __shared__ int sh_go;         // 1: evaluate sh_pose, 0: the solve has ended
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nranks = (int)cluster.num_blocks();
  const bool scalar_thread = threadIdx.x == 0;

  const unsigned t_start = clock();
  unsigned cycles[5] = {0, 0, 0, 0, 0};  // load, sums, reduce, scalar, kernel
  const Camera k = {intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3], intrinsics[4]};
  Candidate cache[kCached];
  load_cached(lv, k, rank, nranks, cache);
  cycles[0] = clock() - t_start;

  // the scalar state lives in thread 0 of every block
  LMState state;
  Motion candidate = load_motion(state_in);
  const Motion model_in = candidate;
  const bool failed_in = state_in[7] != 0.0f;
  int nb_iter = 0, nb_evals = 0;
  bool failed = false;
  if (scalar_thread) store_motion(sh_pose, candidate);
  __syncthreads();

  for (int parity = 0;; parity ^= 1) {
    const unsigned t_eval = clock();
    const Motion m = load_motion(sh_pose);
    float s[kSums];
    thread_sums(lv, k, m, cache, rank, nranks, s);
    const unsigned t_sums = clock();
    cluster_reduce(s, sh, parity, cluster);
    const unsigned t_reduced = clock();
    cycles[1] += t_sums - t_eval;
    cycles[2] += t_reduced - t_sums;

    if (scalar_thread) {
      const float new_energy = sh.total[27] / sh.total[28];  // NaN when nothing is inside
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
        state.energy = new_energy;
#pragma unroll
        for (int t = 0; t < 21; ++t) state.h[t] = sh.total[t];
#pragma unroll
        for (int t = 0; t < 6; ++t) state.g[t] = sh.total[21 + t];
      }
      int go = 0;
      if (cont && nb_iter < max_iterations + 3) {
        ++nb_iter;
        float delta[6];
        damped_solve(state.h, state.g, state.lm, delta);
        candidate = lm_step(state.model, delta);
        if (all_finite(candidate)) {
          store_motion(sh_pose, candidate);
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
    if (scalar_thread) store_motion(sh_pose, frozen ? model_in : state.model);
    __syncthreads();
    const Motion handed_on = load_motion(sh_pose);
    const float flow = flow_level.n > 0 ? mean_flow(flow_level, handed_on, sh) : 0.0f;
    if (scalar_thread) {
      cycles[4] = clock() - t_start;
      write_record(record, handed_on, frozen, state, nb_iter, nb_evals, failed, flow, cycles);
    }
  }
  cluster.sync();  // no block leaves while its sums may still be read
}

}  // namespace

extern "C" {

int vors_lm_record_size() { return kRecord; }

// One launch on `stream` as `lanes` clusters of `cluster` (1, 2, 4 or 8)
// blocks, one cluster per lane: the LM solve of one level of every lane from
// the pose in its `state_in` (8 floats: pose, failed-so-far flag; lane b's
// at state_in + b * state_stride) into its `record` (72 floats, lane after
// lane); with flow_n > 0 also the mean optical flow of the lane's flow
// candidates.  Images, candidates and flow candidates are laid out lane
// after lane; the intrinsics are shared.  Returns the CUDA error of the
// launch (0 = success).
int vors_lm_solve_level(const void* img, int height, int width, const void* xs, const void* ys,
                        const void* idepth, const void* tmpl, const void* valid,
                        const void* jac, int n, const void* intrinsics, const void* state_in,
                        int state_stride, float lm_coef_init, int max_iterations,
                        float energy_tol, const void* flow_xs, const void* flow_ys,
                        const void* flow_idepth, const void* flow_valid,
                        const void* flow_intrinsics, int flow_n, void* record, int cluster,
                        int lanes, void* stream) {
  const Level lv = {static_cast<const uint8_t*>(img), height, width,
                    static_cast<const float*>(xs), static_cast<const float*>(ys),
                    static_cast<const float*>(idepth), static_cast<const float*>(tmpl),
                    static_cast<const uint8_t*>(valid), static_cast<const float*>(jac), n};
  const FlowLevel flow = {static_cast<const float*>(flow_xs), static_cast<const float*>(flow_ys),
                          static_cast<const float*>(flow_idepth),
                          static_cast<const uint8_t*>(flow_valid),
                          static_cast<const float*>(flow_intrinsics), flow_n};
  return static_cast<int>(launch_cluster(
      lm_solve_level_kernel, cluster, lanes, static_cast<cudaStream_t>(stream), lv,
      static_cast<const float*>(intrinsics), static_cast<const float*>(state_in), state_stride,
      lm_coef_init, max_iterations, energy_tol, flow, static_cast<float*>(record)));
}

// How many clusters of `cluster` blocks of this kernel the card holds at
// once (cudaOccupancyMaxActiveClusters), into *count; returns the CUDA error.
int vors_lm_max_active_clusters(int cluster, int* count) {
  if (!valid_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = cluster_config(cluster, 1, nullptr, attribute);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, lm_solve_level_kernel, &config));
}

}  // extern "C"
