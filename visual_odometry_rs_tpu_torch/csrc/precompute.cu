// The tracker's keyframe precompute in two launches, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes the precompute with
// XLA operations (visual_odometry_rs_tpu/models/tracker.py::
// precompute_keyframe).  The port's plain-torch version,
// models/tracker.py::precompute_keyframe_reference, is the same chain of
// tensor operations: gradients of every level, coarse-to-fine candidate
// selection, the masked inverse depth and its DSO-mean pyramid, and per
// level a compaction of the known pixels into `cap` candidate slots with
// their template values and 6-dof warp Jacobians.
//
// What bounds it on this card.  Neither bytes nor arithmetic: a lane reads
// its u8 pyramid (0.4 MB at 640x480) and int32 depth (1.2 MB) and writes
// about 30,700 candidate slots of 41 bytes, microseconds at 3.35 TB/s.  The
// plain version is some 1,400 small launches a call, and their host
// dispatch is the whole cost.
//
// What the design does about it.  Two facts of the data make two launches
// enough for any number of lanes and levels:
// - Kernel A (maps_kernel): coarse-to-fine selection is all-true at the
//   coarsest level, and every finer mask is decided inside the 2x2 block
//   under a selected coarser pixel; the DSO-mean pyramid fuses 2x2 blocks
//   too.  So the 2^(L-1) x 2^(L-1) tile of level 0 under one coarsest pixel
//   closes both at every level.  One block a tile (a lane's tiles on
//   blockIdx.x/y, the lane on blockIdx.z) selects coarse to fine, then
//   builds the masked inverse depth and fuses it fine to coarse.  Tiles
//   past the coarsest level's extent hold the odd trailing rows and columns:
//   never selected, and fused only from a given finest mask.  The per-level
//   maps (known flag, inverse depth, variance) go to scratch in global
//   memory, block-local, so any level count works with the same code.
// - Kernel B (candidates_kernel): one block a (level, lane).  The known
//   pixels are ranked in the plain version's visit order, 128-pixel chunks
//   in bit-reversed order and natural order inside a chunk: each thread
//   counts one chunk, a block scan gives each chunk its first rank, and the
//   first `cap` known pixels get their slots.  Then every slot is written:
//   x, y, inverse depth, valid, template value and the Jacobian, whose
//   level intrinsics come from a device array.  Counting stops once `cap`
//   pixels are ranked.
// Both kernels read a lane's depth and pyramid at an optional source-lane
// index, and kernel B writes a lane's candidates (and, if asked, its
// template image) at an optional destination row: the batched driver
// precomputes the switching lanes of a clip straight into its keyframe, with
// no gather or scatter launches.
//
// Numbers.  Every float operation of the plain version is done here once,
// in its order, with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, which nvcc
// never contracts into an FMA: the results are the plain version's bits on
// this card (torch's CUDA operators round each operation).  Gradients are
// exact small integers in f32, and the truncating division by 2 is
// truncf(x * 0.5f), as torch computes it, so the sign of a zero is kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 12;
constexpr int kChunk = 128;  // pixels of a chunk of a level's flat index
constexpr int kMapThreads = 128;
constexpr int kCandThreads = 512;
constexpr int kCandWarps = kCandThreads / 32;

struct Level {
  const uint8_t* image;  // (source lanes, h, w) u8 pyramid level
  int h, w;
  int cap;               // candidate slots of the level: a row of the outputs
  long long map_stride;  // elements from one lane's maps to the next: chunks * 128
  uint8_t* known;        // (lanes, map_stride) scratch: 0/1
  float* idepth;         // (lanes, map_stride) scratch
  float* variance;       // (lanes, map_stride) scratch; not used at level 0
  int* order;            // (lanes, cap) scratch: the pixel of each slot
  // outputs, (destination rows, cap[, 6]), lane k at row dst_lane[k]
  float* xs;
  float* ys;
  float* z;
  uint8_t* valid;
  float* tmpl;
  float* jac;
  uint8_t* templ;  // (destination rows, h, w), or null: no copy of the image
};

struct Params {
  int levels;
  int lanes;
  const int32_t* depth;        // (source lanes, h0, w0)
  const uint8_t* finest_mask;  // (lanes, h0, w0) 0/1, or null: coarse-to-fine selection
  const long long* src_lane;   // (lanes,) or null: lane k reads source lane k
  const long long* dst_lane;   // (lanes,) or null: lane k writes row k
  float scale;                 // depth units a metre: idepth = scale / max(depth, 1)
  float variance;              // the inverse depth's variance at level 0
  float threshold;             // the selection's difference threshold
  const float* intrinsics;     // (levels, 5): cx cy fx fy skew of each level
  int32_t* counts;             // (lanes, levels): valid slots
  Level lv[kMaxLevels];
};

__device__ __forceinline__ long long source(const Params& p, int k) {
  return p.src_lane != nullptr ? p.src_lane[k] : k;
}

// Squared gradient norm of pixel (y, x) of level l, an exact integer: the
// centred gradient at level 0 (zero on the 1-pixel border), the 2x2-block
// gradient of the level below elsewhere.  C's `/` truncates toward zero
// like the plain version's division.
__device__ int gradient_sq(const Params& p, int l, long long src, int y, int x) {
  if (l == 0) {
    const Level& v = p.lv[0];
    if (y < 1 || y > v.h - 2 || x < 1 || x > v.w - 2) return 0;
    const uint8_t* im = v.image + src * v.h * v.w + (long long)y * v.w + x;
    const int gx = (int(im[1]) - int(im[-1])) / 2;
    const int gy = (int(im[v.w]) - int(im[-v.w])) / 2;
    return gx * gx + gy * gy;
  }
  const Level& f = p.lv[l - 1];
  const uint8_t* im = f.image + src * f.h * f.w + 2LL * y * f.w + 2 * x;
  const int a = im[0], b = im[f.w], c = im[1], d = im[f.w + 1];
  const int gx = (c + d - a - b) / 2;
  const int gy = (b - a + d - c) / 2;
  return gx * gx + gy * gy;
}

// Float gradient (gx, gy) of pixel (y, x) of level l, with the plain
// version's operations: differences of the f32 intensities, then
// truncf(x * 0.5f).
__device__ void gradient(const Params& p, int l, long long src, int y, int x, float& gx, float& gy) {
  if (l == 0) {
    const Level& v = p.lv[0];
    gx = 0.0f;
    gy = 0.0f;
    if (y < 1 || y > v.h - 2 || x < 1 || x > v.w - 2) return;
    const uint8_t* im = v.image + src * v.h * v.w + (long long)y * v.w + x;
    gx = truncf(__fmul_rn(__fsub_rn(float(im[1]), float(im[-1])), 0.5f));
    gy = truncf(__fmul_rn(__fsub_rn(float(im[v.w]), float(im[-v.w])), 0.5f));
    return;
  }
  const Level& f = p.lv[l - 1];
  const uint8_t* im = f.image + src * f.h * f.w + 2LL * y * f.w + 2 * x;
  const float a = im[0], b = im[f.w], c = im[1], d = im[f.w + 1];
  gx = truncf(__fmul_rn(__fsub_rn(__fsub_rn(__fadd_rn(c, d), a), b), 0.5f));
  gy = truncf(__fmul_rn(__fsub_rn(__fadd_rn(__fsub_rn(b, a), d), c), 0.5f));
}

// Keep flags of the corners a, b, c, d of one 2x2 block (coarse_to_fine.rs:
// 73-89, core/candidates/coarse_to_fine.py::_prune_block): the largest, and
// the second if second > third + threshold; ties break a < b < c < d.
__device__ void prune(float threshold, const float g[4], bool keep[4]) {
  const float a = g[0], b = g[1], c = g[2], d = g[3];
  const bool ab = a >= b, ac = a >= c, ad = a >= d, bc = b >= c, bd = b >= d, cd = c >= d;
  const int rank[4] = {!ab + !ac + !ad, ab + !bc + !bd, ac + bc + !cd, ad + bd + cd};
  const float s1 = fmaxf(a, b), t1 = fminf(a, b), s2 = fmaxf(c, d), t2 = fminf(c, d);
  const float mid1 = fminf(s1, s2), mid2 = fmaxf(t1, t2);
  const bool keep_second = fmaxf(mid1, mid2) > __fadd_rn(fminf(mid1, mid2), threshold);
#pragma unroll
  for (int i = 0; i < 4; ++i) keep[i] = rank[i] == 0 || (rank[i] == 1 && keep_second);
}

// Kernel A: the per-pixel maps of every level inside one tile of one lane.
// The scratch maps are written and read by this block only; __syncthreads
// makes each level's writes visible before the next level reads them.
__global__ void __launch_bounds__(kMapThreads) maps_kernel(const __grid_constant__ Params p) {
  const int k = blockIdx.z, tx = blockIdx.x, ty = blockIdx.y;
  const long long src = source(p, k);
  const int nl = p.levels;
  const Level& top = p.lv[nl - 1];
  const bool selecting = p.finest_mask == nullptr;
  const bool rooted = ty < top.h && tx < top.w;  // the tile lies under a coarsest pixel

  // coarse-to-fine selection into the known maps, which hold the masks until
  // the inverse depth replaces them
  if (selecting && rooted) {
    if (threadIdx.x == 0) top.known[k * top.map_stride + (long long)ty * top.w + tx] = 1;
    __syncthreads();
    for (int l = nl - 2; l >= 0; --l) {
      const Level& fine = p.lv[l];
      const Level& coarse = p.lv[l + 1];
      const int side = 1 << (nl - 2 - l);  // the tile's pixels a side at level l + 1
      for (int i = threadIdx.x; i < side * side; i += blockDim.x) {
        const int py = ty * side + i / side, px = tx * side + i % side;
        const bool pre = coarse.known[k * coarse.map_stride + (long long)py * coarse.w + px] != 0;
        bool keep[4] = {false, false, false, false};
        if (pre) {
          float g[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {  // corners a, b, c, d
            g[c] = float(gradient_sq(p, l, src, 2 * py + (c & 1), 2 * px + (c >> 1)));
          }
          prune(p.threshold, g, keep);
        }
        uint8_t* out = fine.known + k * fine.map_stride + 2LL * py * fine.w + 2 * px;
        out[0] = keep[0];
        out[fine.w] = keep[1];
        out[1] = keep[2];
        out[fine.w + 1] = keep[3];
      }
      __syncthreads();
    }
  }

  // level 0: the inverse depth of the depth map, kept on the finest mask
  const int side0 = 1 << (nl - 1);
  const Level& v0 = p.lv[0];
  {
    const int y0 = ty * side0, x0 = tx * side0;
    const int th = min(side0, v0.h - y0), tw = min(side0, v0.w - x0);  // both >= 1
    for (int i = threadIdx.x; i < th * tw; i += blockDim.x) {
      const int y = y0 + i / tw, x = x0 + i % tw;
      const long long pix = (long long)y * v0.w + x;
      const long long at = k * v0.map_stride + pix;
      bool mask;
      if (!selecting) {
        mask = p.finest_mask[(long long)k * v0.h * v0.w + pix] != 0;
      } else {
        mask = rooted && v0.known[at] != 0;
      }
      const int32_t d = p.depth[src * v0.h * v0.w + pix];
      const bool known = mask && d > 0;
      v0.known[at] = known;
      v0.idepth[at] = known ? __fdiv_rn(p.scale, fmaxf(__int2float_rn(d), 1.0f)) : 0.0f;
    }
  }
  __syncthreads();

  // levels 1..: the DSO mean of each 2x2 block (core/inverse_depth.py::
  // fuse_dso_mean), sums in corner order a, b, c, d
  for (int l = 1; l < nl; ++l) {
    const Level& fine = p.lv[l - 1];
    const Level& v = p.lv[l];
    const int side = side0 >> l;
    const int y0 = ty * side, x0 = tx * side;
    const int th = max(0, min(side, v.h - y0)), tw = max(0, min(side, v.w - x0));
    for (int i = threadIdx.x; i < th * tw; i += blockDim.x) {
      const int y = y0 + i / tw, x = x0 + i % tw;
      float vsum = 0.0f, dsum = 0.0f, count = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long at = k * fine.map_stride + (long long)(2 * y + (c & 1)) * fine.w + 2 * x + (c >> 1);
        const float valid = fine.known[at] != 0 ? 1.0f : 0.0f;
        const float var = l == 1 ? (valid != 0.0f ? p.variance : 0.0f) : fine.variance[at];
        const float vv = __fmul_rn(var, valid);
        const float dv = __fmul_rn(__fmul_rn(fine.idepth[at], var), valid);
        vsum = c == 0 ? vv : __fadd_rn(vsum, vv);
        dsum = c == 0 ? dv : __fadd_rn(dsum, dv);
        count = __fadd_rn(count, valid);
      }
      const bool known = count > 0.0f;
      const long long at = k * v.map_stride + (long long)y * v.w + x;
      v.known[at] = known;
      v.idepth[at] = known ? __fdiv_rn(dsum, vsum) : 0.0f;
      v.variance[at] = known ? vsum : 0.0f;
    }
    __syncthreads();
  }
}

// Exclusive prefix sum of `value` over the block; `total` gets the sum.
__device__ int block_exclusive_scan(int value, int& total, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inclusive = value;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inclusive, o);
    if (lane >= o) inclusive += n;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kCandWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    if (lane < kCandWarps) warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  total = warp_sums[kCandWarps - 1];
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + inclusive - value;
}

// The 128 known flags of chunk `c` of a lane's map as 4 words of bits; flags
// past the level's last pixel are cleared (the map's row is padded to whole
// chunks, so the loads stay inside it).
__device__ void chunk_bits(const uint8_t* known, int c, int hw, uint32_t bits[4]) {
  const uint4* row = reinterpret_cast<const uint4*>(known + (long long)c * kChunk);
#pragma unroll
  for (int q = 0; q < 4; ++q) bits[q] = 0;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const uint4 word = row[v];
    const uint32_t w4[4] = {word.x, word.y, word.z, word.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // bit 0 of each of the word's 4 bytes
      const uint32_t w = w4[j];
      const uint32_t nib = (w & 1u) | ((w >> 7) & 2u) | ((w >> 14) & 4u) | ((w >> 21) & 8u);
      bits[v >> 1] |= nib << (4 * (4 * (v & 1) + j));
    }
  }
  const int left = hw - c * kChunk;  // pixels of this chunk inside the level
  if (left < kChunk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int keep = min(max(left - 32 * q, 0), 32);
      bits[q] &= keep == 32 ? 0xffffffffu : ((1u << keep) - 1u);
    }
  }
}

// Kernel B: the candidate slots of one level of one lane
// (models/tracker.py::_compaction_indices, warp_jacobian).
__global__ void __launch_bounds__(kCandThreads) candidates_kernel(const __grid_constant__ Params p) {
  __shared__ int warp_sums[kCandWarps];
  const int l = blockIdx.x, k = blockIdx.y;
  const Level& v = p.lv[l];
  const long long src = source(p, k);
  const long long dst = p.dst_lane != nullptr ? p.dst_lane[k] : k;
  const int hw = v.h * v.w;
  const int chunks = (hw + kChunk - 1) / kChunk;
  const int nbits = max(1, 32 - __clz(chunks - 1));
  const int visits = 1 << nbits;
  const uint8_t* known = v.known + k * v.map_stride;
  int* order = v.order + (long long)k * v.cap;

  // rank the known pixels; slot r < cap gets the pixel of rank r
  int ranked = 0;
  for (int base = 0; base < visits && ranked < v.cap; base += kCandThreads) {
    const int r = base + threadIdx.x;
    const int c = r < visits ? int(__brev(uint32_t(r)) >> (32 - nbits)) : chunks;
    uint32_t bits[4] = {0, 0, 0, 0};
    if (c < chunks) chunk_bits(known, c, hw, bits);
    const int n = __popc(bits[0]) + __popc(bits[1]) + __popc(bits[2]) + __popc(bits[3]);
    int total;
    int rank = ranked + block_exclusive_scan(n, total, warp_sums);
    for (int q = 0; q < 4 && rank < v.cap; ++q) {
      uint32_t b = bits[q];
      while (b != 0u && rank < v.cap) {
        const int j = __ffs(b) - 1;
        b &= b - 1u;
        order[rank++] = c * kChunk + 32 * q + j;
      }
    }
    ranked += total;
  }
  const int filled = min(ranked, v.cap);
  __syncthreads();  // order[] is read by other threads below

  const float* K = p.intrinsics + 5 * l;
  const float cu = K[0], cv = K[1], fu = K[2], fv = K[3], s = K[4];
  const float inv_fv = __fdiv_rn(1.0f, fv);
  const float inv_fuv = __fdiv_rn(1.0f, __fmul_rn(fu, fv));
  const float neg_fu_fu = __fmul_rn(-fu, fu);
  const uint8_t* image = v.image + src * hw;
  const float* idepth = v.idepth + k * v.map_stride;
  for (int slot = threadIdx.x; slot < v.cap; slot += kCandThreads) {
    const long long o = dst * v.cap + slot;
    float* jac = v.jac + 6 * o;
    if (slot >= filled) {  // padding: index 0, everything zero
      v.xs[o] = 0.0f;
      v.ys[o] = 0.0f;
      v.z[o] = 0.0f;
      v.valid[o] = 0;
      v.tmpl[o] = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) jac[j] = 0.0f;
      continue;
    }
    const int pix = order[slot];
    const int y = pix / v.w, x = pix - y * v.w;
    float gu, gv;
    gradient(p, l, src, y, x, gu, gv);
    const float xf = float(x), yf = float(y), z = idepth[pix];
    // warp_jacobian (inverse_compositional.rs:313-341), operation by operation
    const float a = __fsub_rn(xf, cu);
    const float b = __fsub_rn(yf, cv);
    const float c = __fsub_rn(__fmul_rn(a, fv), __fmul_rn(s, b));
    v.xs[o] = xf;
    v.ys[o] = yf;
    v.z[o] = z;
    v.valid[o] = 1;
    v.tmpl[o] = float(image[pix]);
    jac[0] = __fmul_rn(__fmul_rn(gu, z), fu);
    jac[1] = __fmul_rn(z, __fadd_rn(__fmul_rn(gu, s), __fmul_rn(gv, fv)));
    jac[2] = __fmul_rn(-z, __fadd_rn(__fmul_rn(gu, a), __fmul_rn(gv, b)));
    jac[3] = __fadd_rn(__fmul_rn(gu, __fsub_rn(__fmul_rn(__fmul_rn(-a, b), inv_fv), s)),
                       __fmul_rn(gv, __fsub_rn(__fmul_rn(__fmul_rn(-b, b), inv_fv), fv)));
    jac[4] = __fadd_rn(__fmul_rn(gu, __fadd_rn(__fmul_rn(__fmul_rn(a, c), inv_fuv), fu)),
                       __fmul_rn(gv, __fmul_rn(__fmul_rn(b, c), inv_fuv)));
    jac[5] = __fadd_rn(
        __fmul_rn(__fmul_rn(gu, __fadd_rn(__fmul_rn(neg_fu_fu, b), __fmul_rn(s, c))), inv_fuv),
        __fmul_rn(gv, __fdiv_rn(c, fu)));
  }
  if (threadIdx.x == 0) p.counts[k * p.levels + l] = filled;

  if (v.templ != nullptr) {  // the lane's image at this level into its row of the keyframe
    uint8_t* out = v.templ + dst * hw;
    const bool aligned = ((reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const int vec = aligned ? hw / 16 : 0;
    for (int i = threadIdx.x; i < vec; i += kCandThreads) {
      reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(image)[i];
    }
    for (int i = 16 * vec + threadIdx.x; i < hw; i += kCandThreads) out[i] = image[i];
  }
}

}  // namespace

extern "C" {

int vors_precompute_params_size() { return sizeof(Params); }
int vors_precompute_max_levels() { return kMaxLevels; }

// Both launches on `stream`: kernel A over the tiles of every lane, then
// kernel B over every (level, lane).  `params` points to a Params (a void
// pointer: a type of this file's anonymous namespace would keep the symbol
// from being exported).  Returns the CUDA error of the first launch that
// failed (0 = success).
int vors_precompute_keyframe(const void* params, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  if (p.levels < 1 || p.levels > kMaxLevels || p.lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int side = 1 << (p.levels - 1);
  const dim3 tiles((p.lv[0].w + side - 1) / side, (p.lv[0].h + side - 1) / side, p.lanes);
  maps_kernel<<<tiles, kMapThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  candidates_kernel<<<dim3(p.levels, p.lanes), kCandThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
