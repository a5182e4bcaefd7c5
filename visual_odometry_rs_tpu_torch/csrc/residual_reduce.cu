// One fused LM evaluation of one pyramid level, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `fused_residual_reduce` of
// visual_odometry_rs_tpu/ops/pallas/residual_kernel.py: warp every candidate
// by the pose, sample the current image, form the residuals and reduce, over
// the inside points, H = sum J^T J (6x6), g = sum J^T r, sum r^2 and the
// inside count.  Writes [H | g] (6x7, row-major), sum r^2, count.
//
// Design.  The per-candidate arithmetic and the reduction are the shared
// device functions of residual_eval.cuh, the same ones the per-level LM
// solver (lm_solve.cu) runs.  One launch: a thread block cluster sums
// across its blocks through distributed shared memory in rank order, so
// there is no partials buffer in global memory, no second launch and no
// float atomic.  The pose and intrinsics come from a 12-float device buffer
// [qw qx qy qz tx ty tz cx cy fx fy skew], so no launch waits on the host.
//
// What bounds it on this card: a level carries at most 8192 candidates of
// 41 bytes each plus a u8 image that stays in the 50 MB L2, a fraction of
// a microsecond of memory traffic.  The time of a call is the latency of one
// launch and of one thread's dependent chain (divide, four L2 taps, the
// reduction), not bandwidth or arithmetic.

#include "residual_eval.cuh"

namespace {

using namespace vors;

constexpr int kOut = 44;  // [H | g] 6x7 row-major, sum r^2, count

__global__ void __launch_bounds__(kThreads)
residual_reduce_kernel(Level lv, const float* __restrict__ params, float* __restrict__ out) {
  __shared__ ReduceShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nranks = (int)cluster.num_blocks();

  const Motion m = {params[0], params[1], params[2], params[3], params[4], params[5], params[6]};
  const Camera k = {params[7], params[8], params[9], params[10], params[11]};

  Candidate cache[kCached];
  load_cached(lv, k, rank, nranks, cache);
  float s[kSums];
  thread_sums(lv, k, m, cache, rank, nranks, s);
  cluster_reduce(s, sh, 0, cluster);

  const int t = threadIdx.x;
  if (rank == 0 && t < kOut) {
    float val;
    if (t < 42) {
      const int row = t / 7;
      const int col = t % 7;
      if (col == 6) {
        val = sh.total[21 + row];
      } else {
        val = sh.total[row < col ? upper_index(row, col) : upper_index(col, row)];
      }
    } else {
      val = sh.total[27 + (t - 42)];
    }
    out[t] = val;
  }
  cluster.sync();  // no block leaves while its sums may still be read
}

}  // namespace

extern "C" {

// One launch on `stream` as a cluster of `cluster` (1, 2, 4 or 8) blocks;
// returns the CUDA error of the launch (0 = success).  `out` holds 44 floats.
int vors_residual_reduce(const void* img, int height, int width, const void* xs,
                         const void* ys, const void* idepth, const void* tmpl,
                         const void* valid, const void* jac, int n, const void* params,
                         void* out, int cluster, void* stream) {
  const Level lv = {static_cast<const uint8_t*>(img), height, width,
                    static_cast<const float*>(xs), static_cast<const float*>(ys),
                    static_cast<const float*>(idepth), static_cast<const float*>(tmpl),
                    static_cast<const uint8_t*>(valid), static_cast<const float*>(jac), n};
  return static_cast<int>(launch_cluster(residual_reduce_kernel, cluster, 1,
                                         static_cast<cudaStream_t>(stream), lv,
                                         static_cast<const float*>(params),
                                         static_cast<float*>(out)));
}

}  // extern "C"
