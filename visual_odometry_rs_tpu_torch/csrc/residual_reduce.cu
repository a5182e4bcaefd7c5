// Fused LM evaluation of one pyramid level, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` / `fused_residual_reduce` of
// visual_odometry_rs_tpu/ops/pallas/residual_kernel.py.  For every candidate
// point it back-projects with skewed intrinsics, rotates by the quaternion
// and translates, projects to (u, v), tests the reference's interpolation
// domain (0 <= floor(u) < W-2, 0 <= floor(v) < H-2), samples the u8 image
// bilinearly and forms the residual r = I(u, v) - T.  It then reduces, over
// the inside points, H = sum J^T J (6x6), g = sum J^T r, sum r^2 and the
// inside count, and writes [H | g] (6x7, row-major), sum r^2, count.
//
// Design.  One thread per candidate; the four bilinear taps are read from
// the u8 image in global memory (a 640x480 level 0 is 300 KB and stays in
// the 50 MB L2).  Each block reduces the 29 distinct sums (21 of H's upper
// triangle, 6 of g, sum r^2, count) with warp shuffles and shared memory and
// writes them to a (num_blocks, 29) scratch; a second launch sums the
// partials in a fixed order.  No float atomics: a sum whose order changes
// from run to run can flip the LM accept/reject test near energy_tol.  The
// pose and intrinsics come from a 12-float device buffer
// [qw qx qy qz tx ty tz cx cy fx fy skew], so no launch waits on the host.
//
// What bounds it on this card: the tracker's levels carry at most 8192
// candidates, i.e. at most 32 blocks of 256 threads on 132 SMs, and each
// thread moves about 50 bytes.  The kernel is bound by launch latency and by
// the dependent load chain of one thread, not by bandwidth or arithmetic.
// The later steps are to evaluate several LM lanes (sequences) per launch
// and to run the whole per-level LM loop (6x6 Cholesky, se3 exp and the
// accept/reject rule) inside one kernel, which removes the per-iteration
// launches and host syncs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;  // 21 (H upper triangle) + 6 (g) + sum r^2 + count
constexpr int kOut = 44;   // [H | g] 6x7 row-major, sum r^2, count

__global__ void __launch_bounds__(kThreads)
residual_partials_kernel(const uint8_t* __restrict__ img, int height, int width,
                         const float* __restrict__ xs, const float* __restrict__ ys,
                         const float* __restrict__ idepth, const float* __restrict__ tmpl,
                         const uint8_t* __restrict__ valid, const float* __restrict__ jac,
                         int n, const float* __restrict__ params,
                         float* __restrict__ partials) {
  __shared__ float warp_sums[kWarps][kSums];
  const int i = blockIdx.x * kThreads + threadIdx.x;

  float s[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = 0.0f;

  if (i < n) {
    const float qw = params[0], qx = params[1], qy = params[2], qz = params[3];
    const float tx = params[4], ty = params[5], tz = params[6];
    const float cx = params[7], cy = params[8], fx = params[9], fy = params[10];
    const float skew = params[11];

    // back-project (camera.rs:135-140); padding has idepth 0 -> inf/NaN,
    // which the inside test below rejects before any float->int cast
    const float depth = 1.0f / idepth[i];
    const float py = (ys[i] - cy) * depth / fy;
    const float px = ((xs[i] - cx) * depth - skew * py) / fx;
    const float pz = depth;
    // rotate by the quaternion in the cross-product form, then translate
    const float tvx = 2.0f * (qy * pz - qz * py);
    const float tvy = 2.0f * (qz * px - qx * pz);
    const float tvz = 2.0f * (qx * py - qy * px);
    const float rx = px + qw * tvx + (qy * tvz - qz * tvy) + tx;
    const float ry = py + qw * tvy + (qz * tvx - qx * tvz) + ty;
    const float rz = pz + qw * tvz + (qx * tvy - qy * tvx) + tz;
    // project and dehomogenize (camera.rs:126-132)
    const float u = (fx * rx + skew * ry + cx * rz) / rz;
    const float v = (fy * ry + cy * rz) / rz;

    const float uf = floorf(u);
    const float vf = floorf(v);
    // comparisons with NaN are false, so NaN/inf coordinates are outside
    const bool inside = valid[i] != 0 && uf >= 0.0f && uf < (float)(width - 2) &&
                        vf >= 0.0f && vf < (float)(height - 2);
    if (inside) {
      const int u0 = (int)uf;
      const int v0 = (int)vf;
      const float a = u - uf;
      const float b = v - vf;
      const uint8_t* p = img + (size_t)v0 * width + u0;
      const float v00 = (float)__ldg(p);
      const float v01 = (float)__ldg(p + 1);
      const float v10 = (float)__ldg(p + width);
      const float v11 = (float)__ldg(p + width + 1);
      const float val = (1.0f - b) * (1.0f - a) * v00 + b * (1.0f - a) * v10 +
                        (1.0f - b) * a * v01 + b * a * v11;
      const float r = val - tmpl[i];

      float j[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) j[c] = jac[(size_t)i * 6 + c];
      int k = 0;
#pragma unroll
      for (int r0 = 0; r0 < 6; ++r0) {
#pragma unroll
        for (int c = r0; c < 6; ++c) s[k++] = j[r0] * j[c];
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) s[21 + c] = j[c] * r;
      s[27] = r * r;
      s[28] = 1.0f;
    }
  }

  // fixed-order reduction: warp shuffles, then the warps in index order
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[warp][k] = s[k];
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += warp_sums[w][threadIdx.x];
    partials[(size_t)blockIdx.x * kSums + threadIdx.x] = acc;
  }
}

__global__ void residual_finalize_kernel(const float* __restrict__ partials, int num_blocks,
                                         float* __restrict__ out) {
  __shared__ float sums[kSums];
  const int t = threadIdx.x;
  if (t < kSums) {
    float acc = 0.0f;
    for (int b = 0; b < num_blocks; ++b) acc += partials[(size_t)b * kSums + t];
    sums[t] = acc;
  }
  __syncthreads();
  if (t < kOut) {
    float val;
    if (t < 42) {
      const int row = t / 7;
      const int col = t % 7;
      if (col == 6) {
        val = sums[21 + row];
      } else {
        const int a = row < col ? row : col;
        const int b = row < col ? col : row;
        val = sums[6 * a - a * (a - 1) / 2 + (b - a)];  // upper-triangle index
      }
    } else {
      val = sums[27 + (t - 42)];
    }
    out[t] = val;
  }
}

}  // namespace

extern "C" {

int vors_residual_num_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = success).
// `partials` holds max(1, vors_residual_num_blocks(n)) * 29 floats, `out` 44.
int vors_residual_reduce(const void* img, int height, int width, const void* xs,
                         const void* ys, const void* idepth, const void* tmpl,
                         const void* valid, const void* jac, int n, const void* params,
                         void* partials, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int num_blocks = vors_residual_num_blocks(n);
  if (num_blocks > 0) {
    residual_partials_kernel<<<num_blocks, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(img), height, width, static_cast<const float*>(xs),
        static_cast<const float*>(ys), static_cast<const float*>(idepth),
        static_cast<const float*>(tmpl), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(jac), n, static_cast<const float*>(params),
        static_cast<float*>(partials));
  }
  residual_finalize_kernel<<<1, 64, 0, st>>>(static_cast<const float*>(partials), num_blocks,
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
