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
// sample the u8 image bilinearly, form the residual and add to the sums of
// the normal equations: the upper triangle of H, g, sum r^2 and the inside
// count.
//
// Two options of the tracker change the sums, and each is a template
// parameter, so that the plain evaluation compiles to exactly the code it had
// before the options existed:
// - NP = 8, the affine brightness model (models/tracker.py::
//   _eval_full_brightness of the JAX package): r = I - (a T + b), and the
//   Jacobian row gains the columns [T | 1], so H is 8x8 and there are
//   36 + 8 + 2 = 46 sums instead of 21 + 6 + 2 = 29;
// - kRobust, Huber IRLS weights (robust_delta): for an inside candidate
//   w = |r| <= delta ? 1 : delta / max(|r|, 1e-12) weights H, g and sum r^2
//   as (w J) J^T, (w J) r and (w r) r, the JAX package's order; the count
//   stays unweighted.  With w = 1 these are the unweighted sums bit for bit.
//
// Layout of a launch.  One thread block cluster of 1, 2, 4 or 8 blocks of
// 256 threads works on one level.  Candidate i belongs to thread
// i % 256 of block (i / 256) % nblocks; a thread keeps its first kCached
// candidates in registers (back-projected point, template value, Jacobian
// row), which covers 8192 candidates in a cluster of 8 (two for the plain
// brightness build, see cached_count), and reads any further ones from
// global memory at every evaluation.  The cross-block sum
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
constexpr int kCached = 4;      // candidates a thread keeps in registers (6 parameters)
constexpr int kMaxCluster = 8;  // the portable cluster size limit

// Candidates a thread keeps in registers.  The plain brightness solver
// spills with four (255 registers and 200 bytes spilled on sm_90a) and does
// not with two; with the Huber weights it fits four (224 registers), and two
// would make it slower.  residual_reduce uses the same count, so that its
// sums stay the solver's bit for bit.
__host__ __device__ constexpr int cached_count(int np, bool robust) {
  return np == 8 && !robust ? 2 : kCached;
}

// Sums of an evaluation with NP parameters: H's upper triangle, g, sum r^2, count.
__host__ __device__ constexpr int tri_size(int np) { return np * (np + 1) / 2; }
__host__ __device__ constexpr int sum_count(int np) { return tri_size(np) + np + 2; }

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

// What the options add to an evaluation: the brightness gain and bias (read
// when NP = 8) and the Huber threshold (read when kRobust).
struct Photometric {
  float a, b, delta;
};

// What an evaluation needs of one candidate; nothing in it depends on the pose.
struct Candidate {
  float px, py, pz;  // back-projected point (camera.rs:135-140)
  float tmpl;
  float j[6];
  bool valid;
};

template <int S>
struct ReduceShared {
  float warp_sums[kWarps][S];
  float block_sums[2][S];  // double-buffered: read by the whole cluster
  float total[S];
};

// Index of (a, b), a <= b, in the row-major upper triangle of an NP x NP matrix.
template <int NP = 6>
__host__ __device__ constexpr int upper_index(int a, int b) {
  return NP * a - a * (a - 1) / 2 + (b - a);
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
template <int C>
__device__ __forceinline__ void load_cached(const Level& lv, const Camera& k, int rank,
                                            int nranks, Candidate (&cache)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
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

// Warps a valid candidate and samples the image: false when it lands
// outside the interpolation domain, else true with the bilinear value.
__device__ __forceinline__ bool sample(const Candidate& c, const Motion& m, const Camera& k,
                                       const Level& lv, float& val) {
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
    val = (1.0f - b) * (1.0f - a) * v00 + b * (1.0f - a) * v10 + (1.0f - b) * a * v01 +
          b * a * v11;
  }
  return inside;
}

// Adds one candidate's terms to the sums of an NP-parameter evaluation.
template <int NP, bool kRobust>
__device__ __forceinline__ void accumulate(const Candidate& c, const Motion& m, const Camera& k,
                                           const Level& lv, const Photometric& ph,
                                           float (&s)[sum_count(NP)]) {
  constexpr int kTri = tri_size(NP);
  if (!c.valid) return;  // padding, or an empty register slot
  float val;
  if (sample(c, m, k, lv, val)) {
    float r;
    float j[NP];
#pragma unroll
    for (int t = 0; t < 6; ++t) j[t] = c.j[t];
    if constexpr (NP == 8) {
      // the plain version's rounding: a T, then + b (no contraction)
      r = val - __fadd_rn(__fmul_rn(ph.a, c.tmpl), ph.b);
      j[6] = c.tmpl;
      j[7] = 1.0f;
    } else {
      r = val - c.tmpl;
    }
    if constexpr (kRobust) {
      const float absr = fabsf(r);
      const float w = absr <= ph.delta ? 1.0f : ph.delta / fmaxf(absr, 1e-12f);
      float wj[NP];
#pragma unroll
      for (int t = 0; t < NP; ++t) wj[t] = j[t] * w;
      int idx = 0;
#pragma unroll
      for (int r0 = 0; r0 < NP; ++r0) {
#pragma unroll
        for (int c0 = r0; c0 < NP; ++c0) s[idx++] += wj[r0] * j[c0];
      }
#pragma unroll
      for (int c0 = 0; c0 < NP; ++c0) s[kTri + c0] += wj[c0] * r;
      s[kTri + NP] += (w * r) * r;
    } else {
      int idx = 0;
#pragma unroll
      for (int r0 = 0; r0 < NP; ++r0) {
#pragma unroll
        for (int c0 = r0; c0 < NP; ++c0) s[idx++] += j[r0] * j[c0];
      }
#pragma unroll
      for (int c0 = 0; c0 < NP; ++c0) s[kTri + c0] += j[c0] * r;
      s[kTri + NP] += r * r;
    }
    s[kTri + NP + 1] += 1.0f;
  }
}

// This thread's share of the sums at pose `m`: the cached candidates in
// slot order, then the ones beyond the cache in index order.
template <int NP, bool kRobust, int C>
__device__ __forceinline__ void thread_sums(const Level& lv, const Camera& k, const Motion& m,
                                            const Photometric& ph, const Candidate (&cache)[C],
                                            int rank, int nranks, float (&s)[sum_count(NP)]) {
#pragma unroll
  for (int t = 0; t < sum_count(NP); ++t) s[t] = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) accumulate<NP, kRobust>(cache[c], m, k, lv, ph, s);
  const int stride = nranks * kThreads;
  for (int i = (C * nranks + rank) * kThreads + (int)threadIdx.x; i < lv.n; i += stride) {
    accumulate<NP, kRobust>(load_candidate(lv, k, i), m, k, lv, ph, s);
  }
}

// Sums `s` over the whole cluster into sh.total, the same in every block.
// Fixed order: lanes by shuffle, warps by index, blocks by rank.  `parity`
// alternates between calls: a block may write its next sums while a slower
// block still reads the previous ones, and the cluster barrier of the call
// in between keeps the two-calls-old buffer free.  The caller ends the
// kernel with cluster.sync(), so no block leaves while its sums may be read.
template <int S>
__device__ __forceinline__ void cluster_reduce(float (&s)[S], ReduceShared<S>& sh, int parity,
                                               cg::cluster_group& cluster) {
#pragma unroll
  for (int t = 0; t < S; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[t] += __shfl_down_sync(0xffffffffu, s[t], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < S; ++t) sh.warp_sums[warp][t] = s[t];
  }
  __syncthreads();
  if (threadIdx.x < S) {
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
  if (threadIdx.x < S) {
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

// The launch of `lanes` clusters of `cluster` blocks of kThreads threads:
// cluster c is the blocks (0..cluster-1, c) of a (cluster, lanes) grid, so a
// block's lane is blockIdx.y.  `attribute` must outlive `config`.
inline cudaLaunchConfig_t cluster_config(int cluster, int lanes, cudaStream_t stream,
                                         cudaLaunchAttribute& attribute) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, lanes);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = cluster;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  return config;
}

inline bool valid_cluster(int cluster) {
  return cluster == 1 || cluster == 2 || cluster == 4 || cluster == kMaxCluster;
}

// Launches `kernel` as `lanes` clusters of `cluster` blocks.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), int cluster, int lanes,
                                  cudaStream_t stream, Args... args) {
  if (!valid_cluster(cluster) || lanes < 1 || lanes > 65535) return cudaErrorInvalidValue;
  cudaLaunchAttribute attribute;
  const cudaLaunchConfig_t config = cluster_config(cluster, lanes, stream, attribute);
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

// Registers and local (spilled) bytes a thread of `kernel` uses, into
// regs[0] and regs[1] (cudaFuncGetAttributes); returns the CUDA error.
template <typename... Params>
inline int kernel_resources(void (*kernel)(Params...), int* regs) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    regs[0] = attr.numRegs;
    regs[1] = (int)attr.localSizeBytes;
  }
  return static_cast<int>(err);
}

}  // namespace vors
