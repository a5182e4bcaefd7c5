// The LM evaluation of one pyramid level, as device functions shared by the
// single-evaluation kernel (residual_reduce.cu) and the per-level LM solver
// (lm_solve.cu), so that the two cannot drift apart: a solve's evaluations
// are bit-equal to residual_reduce at the same pose.
//
// Replaces the body of the Pallas TPU kernel `_kernel` of
// visual_odometry_rs_tpu/ops/pallas/residual_kernel.py.  For every candidate
// point: back-project with skewed intrinsics, rotate by the quaternion and
// translate, project to (u, v), test the reference's interpolation domain
// (0 <= floor(u) < W-2, 0 <= floor(v) < H-2) BEFORE any float->int cast,
// sample the u8 image bilinearly, form r = I(u, v) - T and add to the 29
// sums: 21 of H's upper triangle, 6 of g, sum r^2 and the inside count.
//
// Layout of a launch.  One thread block cluster of 1, 2, 4 or 8 blocks of
// 256 threads works on one level.  Candidate i belongs to thread
// i % 256 of block (i / 256) % nblocks; a thread keeps its first kCached
// candidates in registers (back-projected point, template value, Jacobian
// row), which covers 8192 candidates in a cluster of 8, and reads any
// further ones from global memory at every evaluation.  The cross-block sum
// needs no second launch: every block reduces its sums with warp shuffles
// and shared memory, the cluster synchronises, and every block adds all
// blocks' sums from distributed shared memory in rank order.  The order is
// fixed, so a run repeats bit for bit; there are no float atomics.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vors {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;       // 21 (H upper triangle) + 6 (g) + sum r^2 + count
constexpr int kCached = 4;      // candidates a thread keeps in registers
constexpr int kMaxCluster = 8;  // the portable cluster size limit

// One pyramid level as a launch is given it.
struct Level {
  const uint8_t* img;  // (height, width) u8
  int height, width;
  const float *xs, *ys, *idepth, *tmpl;  // (n,)
  const uint8_t* valid;                   // (n,) bool
  const float* jac;                       // (n, 6)
  int n;
};

struct Camera {
  float cx, cy, fx, fy, skew;
};

struct Motion {  // quaternion [w x y z] and translation
  float qw, qx, qy, qz, tx, ty, tz;
};

// What an evaluation needs of one candidate; nothing in it depends on the pose.
struct Candidate {
  float px, py, pz;  // back-projected point (camera.rs:135-140)
  float tmpl;
  float j[6];
  bool valid;
};

struct ReduceShared {
  float warp_sums[kWarps][kSums];
  float block_sums[2][kSums];  // double-buffered: read by the whole cluster
  float total[kSums];
};

// Index of (a, b), a <= b, in the row-major upper triangle of a 6x6 matrix.
__host__ __device__ constexpr int upper_index(int a, int b) {
  return 6 * a - a * (a - 1) / 2 + (b - a);
}

__device__ __forceinline__ Candidate empty_candidate() {
  Candidate c;
  c.px = c.py = c.pz = c.tmpl = 0.0f;
#pragma unroll
  for (int t = 0; t < 6; ++t) c.j[t] = 0.0f;
  c.valid = false;
  return c;
}

// Padding candidates have idepth 0, so their point is inf/NaN; `accumulate`
// skips them, and its inside test comes before any float->int cast.
__device__ __forceinline__ Candidate load_candidate(const Level& lv, const Camera& k, int i) {
  Candidate c;
  const float depth = 1.0f / lv.idepth[i];
  c.py = (lv.ys[i] - k.cy) * depth / k.fy;
  c.px = ((lv.xs[i] - k.cx) * depth - k.skew * c.py) / k.fx;
  c.pz = depth;
  c.tmpl = lv.tmpl[i];
#pragma unroll
  for (int t = 0; t < 6; ++t) c.j[t] = lv.jac[(size_t)i * 6 + t];
  c.valid = lv.valid[i] != 0;
  return c;
}

// The candidates of this thread that fit in registers.
__device__ __forceinline__ void load_cached(const Level& lv, const Camera& k, int rank,
                                            int nranks, Candidate (&cache)[kCached]) {
#pragma unroll
  for (int c = 0; c < kCached; ++c) {
    const int i = (c * nranks + rank) * kThreads + (int)threadIdx.x;
    cache[c] = i < lv.n ? load_candidate(lv, k, i) : empty_candidate();
  }
}

// Moves the back-projected point by `m` and projects it: pixel (u, v).
__device__ __forceinline__ void warp_point(float px, float py, float pz, const Motion& m,
                                           const Camera& k, float& u, float& v) {
  // rotate by the quaternion in the cross-product form, then translate
  const float tvx = 2.0f * (m.qy * pz - m.qz * py);
  const float tvy = 2.0f * (m.qz * px - m.qx * pz);
  const float tvz = 2.0f * (m.qx * py - m.qy * px);
  const float rx = px + m.qw * tvx + (m.qy * tvz - m.qz * tvy) + m.tx;
  const float ry = py + m.qw * tvy + (m.qz * tvx - m.qx * tvz) + m.ty;
  const float rz = pz + m.qw * tvz + (m.qx * tvy - m.qy * tvx) + m.tz;
  // project and dehomogenize (camera.rs:126-132)
  u = (k.fx * rx + k.skew * ry + k.cx * rz) / rz;
  v = (k.fy * ry + k.cy * rz) / rz;
}

// Adds one candidate's terms to the 29 sums.
__device__ __forceinline__ void accumulate(const Candidate& c, const Motion& m, const Camera& k,
                                           const Level& lv, float (&s)[kSums]) {
  if (!c.valid) return;  // padding, or an empty register slot
  float u, v;
  warp_point(c.px, c.py, c.pz, m, k, u, v);

  const float uf = floorf(u);
  const float vf = floorf(v);
  // comparisons with NaN are false, so NaN/inf coordinates are outside
  const bool inside = uf >= 0.0f && uf < (float)(lv.width - 2) && vf >= 0.0f &&
                      vf < (float)(lv.height - 2);
  if (inside) {
    const int u0 = (int)uf;
    const int v0 = (int)vf;
    const float a = u - uf;
    const float b = v - vf;
    const uint8_t* p = lv.img + (size_t)v0 * lv.width + u0;
    const float v00 = (float)__ldg(p);
    const float v01 = (float)__ldg(p + 1);
    const float v10 = (float)__ldg(p + lv.width);
    const float v11 = (float)__ldg(p + lv.width + 1);
    const float val = (1.0f - b) * (1.0f - a) * v00 + b * (1.0f - a) * v10 +
                      (1.0f - b) * a * v01 + b * a * v11;
    const float r = val - c.tmpl;
    int idx = 0;
#pragma unroll
    for (int r0 = 0; r0 < 6; ++r0) {
#pragma unroll
      for (int c0 = r0; c0 < 6; ++c0) s[idx++] += c.j[r0] * c.j[c0];
    }
#pragma unroll
    for (int c0 = 0; c0 < 6; ++c0) s[21 + c0] += c.j[c0] * r;
    s[27] += r * r;
    s[28] += 1.0f;
  }
}

// This thread's share of the 29 sums at pose `m`: the cached candidates in
// slot order, then the ones beyond the cache in index order.
__device__ __forceinline__ void thread_sums(const Level& lv, const Camera& k, const Motion& m,
                                            const Candidate (&cache)[kCached], int rank,
                                            int nranks, float (&s)[kSums]) {
#pragma unroll
  for (int t = 0; t < kSums; ++t) s[t] = 0.0f;
#pragma unroll
  for (int c = 0; c < kCached; ++c) accumulate(cache[c], m, k, lv, s);
  const int stride = nranks * kThreads;
  for (int i = (kCached * nranks + rank) * kThreads + (int)threadIdx.x; i < lv.n; i += stride) {
    accumulate(load_candidate(lv, k, i), m, k, lv, s);
  }
}

// Sums `s` over the whole cluster into sh.total, the same in every block.
// Fixed order: lanes by shuffle, warps by index, blocks by rank.  `parity`
// alternates between calls: a block may write its next sums while a slower
// block still reads the previous ones, and the cluster barrier of the call
// in between keeps the two-calls-old buffer free.  The caller ends the
// kernel with cluster.sync(), so no block leaves while its sums may be read.
__device__ __forceinline__ void cluster_reduce(float (&s)[kSums], ReduceShared& sh, int parity,
                                               cg::cluster_group& cluster) {
#pragma unroll
  for (int t = 0; t < kSums; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[t] += __shfl_down_sync(0xffffffffu, s[t], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kSums; ++t) sh.warp_sums[warp][t] = s[t];
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sh.warp_sums[w][threadIdx.x];
    sh.block_sums[parity][threadIdx.x] = acc;
  }
  const int nranks = (int)cluster.num_blocks();
  if (nranks > 1) {
    cluster.sync();
  } else {
    __syncthreads();  // a cluster of one block: the cheaper barrier does
  }
  if (threadIdx.x < kSums) {
    // all loads first, so that their latencies overlap; then the sum in rank order
    float part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < nranks) part[r] = cluster.map_shared_rank(&sh.block_sums[parity][0], r)[threadIdx.x];
    }
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < nranks) acc += part[r];
    }
    sh.total[threadIdx.x] = acc;
  }
  __syncthreads();
}

// Launches `kernel` as one cluster of `cluster` blocks of kThreads threads.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int cluster, cudaStream_t stream,
                                  Args... args) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

}  // namespace vors
