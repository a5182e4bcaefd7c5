// One fused LM evaluation of one pyramid level, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `fused_residual_reduce` of
// visual_odometry_rs_tpu/ops/pallas/residual_kernel.py: warp every candidate
// by the pose, sample the current image, form the residuals and reduce, over
// the inside points, H = sum J^T J, g = sum J^T r, sum r^2 and the inside
// count.  Writes [H | g] (NP x (NP + 1), row-major), sum r^2, count.
//
// The tracker's options are instantiations of the same kernel (see
// residual_eval.cuh): Huber weights (robust_delta > 0) and the affine
// brightness model (an `ab` buffer given: NP = 8, [H | g] 8x9).  The plain
// evaluation (NP = 6, no weights) compiles to the code it had before the
// options existed.
//
// Design.  The per-candidate arithmetic and the reduction are the shared
// device functions of residual_eval.cuh, the same ones the per-level LM
// solver (lm_solve.cu) runs.  One launch: a thread block cluster sums
// across its blocks through distributed shared memory in rank order, so
// there is no partials buffer in global memory, no second launch and no
// float atomic.  The pose and intrinsics come from a 12-float device buffer
// [qw qx qy qz tx ty tz cx cy fx fy skew] (and the gain and bias from a
// 2-float one), so no launch waits on the host.
//
// What bounds it on this card: a level carries at most 8192 candidates of
// 41 bytes each plus a u8 image that stays in the 50 MB L2, a fraction of
// a microsecond of memory traffic.  The time of a call is the latency of one
// launch and of one thread's dependent chain (divide, four L2 taps, the
// reduction), not bandwidth or arithmetic.

#include "residual_eval.cuh"

namespace {

using namespace vors;

// [H | g] NP x (NP + 1) row-major, sum r^2, count
__host__ __device__ constexpr int out_size(int np) { return np * (np + 1) + 2; }

template <int NP, bool kRobust>
__global__ void __launch_bounds__(kThreads)
residual_reduce_kernel(Level lv, const float* __restrict__ params, const float* __restrict__ ab,
                       float robust_delta, float* __restrict__ out) {
  constexpr int S = sum_count(NP);
  constexpr int kTri = tri_size(NP);
  __shared__ ReduceShared<S> sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nranks = (int)cluster.num_blocks();

  const Motion m = {params[0], params[1], params[2], params[3], params[4], params[5], params[6]};
  const Camera k = {params[7], params[8], params[9], params[10], params[11]};
  Photometric ph = {1.0f, 0.0f, robust_delta};
  if constexpr (NP == 8) {
    ph.a = ab[0];
    ph.b = ab[1];
  }

  Candidate cache[cached_count(NP, kRobust)];
  load_cached(lv, k, rank, nranks, cache);
  float s[S];
  thread_sums<NP, kRobust>(lv, k, m, ph, cache, rank, nranks, s);
  cluster_reduce(s, sh, 0, cluster);

  const int t = threadIdx.x;
  if (rank == 0 && t < out_size(NP)) {
    float val;
    if (t < NP * (NP + 1)) {
      const int row = t / (NP + 1);
      const int col = t % (NP + 1);
      if (col == NP) {
        val = sh.total[kTri + row];
      } else {
        val = sh.total[row < col ? upper_index<NP>(row, col) : upper_index<NP>(col, row)];
      }
    } else {
      val = sh.total[kTri + NP + (t - NP * (NP + 1))];
    }
    out[t] = val;
  }
  cluster.sync();  // no block leaves while its sums may still be read
}

template <int NP, bool kRobust>
cudaError_t launch(const Level& lv, const float* params, const float* ab, float robust_delta,
                   float* out, int cluster, cudaStream_t stream) {
  return launch_cluster(residual_reduce_kernel<NP, kRobust>, cluster, 1, stream, lv, params, ab,
                        robust_delta, out);
}

}  // namespace

extern "C" {

// One launch on `stream` as a cluster of `cluster` (1, 2, 4 or 8) blocks;
// returns the CUDA error of the launch (0 = success).  `ab` null: the plain
// 6-parameter evaluation, `out` holds 44 floats; `ab` (gain, bias) given:
// the brightness model, `out` holds 74 floats.  robust_delta > 0 turns on
// the Huber weights.
int vors_residual_reduce(const void* img, int height, int width, const void* xs,
                         const void* ys, const void* idepth, const void* tmpl,
                         const void* valid, const void* jac, int n, const void* params,
                         const void* ab, float robust_delta, void* out, int cluster,
                         void* stream) {
  const Level lv = {static_cast<const uint8_t*>(img), height, width,
                    static_cast<const float*>(xs), static_cast<const float*>(ys),
                    static_cast<const float*>(idepth), static_cast<const float*>(tmpl),
                    static_cast<const uint8_t*>(valid), static_cast<const float*>(jac), n};
  const float* p = static_cast<const float*>(params);
  const float* b = static_cast<const float*>(ab);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool robust = robust_delta > 0.0f;
  cudaError_t err;
  if (b == nullptr) {
    err = robust ? launch<6, true>(lv, p, b, robust_delta, o, cluster, s)
                 : launch<6, false>(lv, p, b, robust_delta, o, cluster, s);
  } else {
    err = robust ? launch<8, true>(lv, p, b, robust_delta, o, cluster, s)
                 : launch<8, false>(lv, p, b, robust_delta, o, cluster, s);
  }
  return static_cast<int>(err);
}

// Registers and local bytes of one instantiation into regs[0], regs[1].
int vors_residual_reduce_resources(int brightness, int robust, int* regs) {
  if (brightness) {
    return robust ? kernel_resources(residual_reduce_kernel<8, true>, regs)
                  : kernel_resources(residual_reduce_kernel<8, false>, regs);
  }
  return robust ? kernel_resources(residual_reduce_kernel<6, true>, regs)
                : kernel_resources(residual_reduce_kernel<6, false>, regs);
}

}  // extern "C"
