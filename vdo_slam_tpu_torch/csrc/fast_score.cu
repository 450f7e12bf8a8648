// FAST-9/16 corner score at two thresholds in one pass, for sm_90a.
//
// Replaces the TPU kernel vdo_slam_tpu/ops/fast_pallas.py:_fast_kernel
// (its launchers _score_pair_single and _score_pair_batched): it computes
// what that kernel computes, not its band-and-DMA structure.
//
// What it computes, per pixel of an fp32 gray image (S, H, W):
//   d_i   = circle_i - centre, i = 0..15 (the radius-3 circle of
//           vdo_slam_tpu/ops/fast.py:_CIRCLE), one fp32 subtraction each;
//   score = max over the 16 contiguous 9-arcs whose d are all > th (or all
//           < -th) of min |d| over the arc, or 0 if no arc qualifies;
//   the 3 px border (y < 3 | y >= H-3 | x < 3 | x >= W-3) is 0.
// The reduction is rewritten without changing a bit of the result:
//   all d > th over an arc   <=>  lo_s = min_arc d       > th
//   all d < -th over an arc  <=>  hi'_s = -max_arc d     > th
// and the arc's score is then lo_s (resp. -max_arc d = min_arc -d).  So with
// M = max(0, max_s max(lo_s, hi'_s)), score(th) = M > th ? M : 0 for any th:
// if any arc qualifies, the largest arc value is > th and qualifies too.
// Both thresholds then cost one compare each.  Only subtraction, negation,
// min, max and compares touch the data, so the result is bit-equal to the
// plain PyTorch version (ops/fast.py:fast_score).  The thresholds arrive as
// float and are compared as float: a double compare would flip pixels whose
// difference lands exactly on fp32(20/255).
//
// What bounds it on an H100: launch count and memory, not arithmetic.  One
// launch per pyramid level (8 per frame, about 1.5 Mpx in all at
// 1242x375); per pixel one 4-byte read (the 16 neighbours hit L1/L2, since
// a 32x8 block touches a 38x14 window) and two 4-byte writes.  The design
// keeps both thresholds in one pass (one read of the image instead of two),
// one thread per pixel in 32x8 blocks so a warp reads a 128-byte row
// segment, and blockIdx.z over streams so a batch is still one launch.
// TMA and wgmma do not apply to a compare-and-min stencil.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
fast_score_pair_kernel(const float* __restrict__ gray,
                       float* __restrict__ out_ini,
                       float* __restrict__ out_min,
                       int H, int W, float th_ini, float th_min) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* img = gray + blockIdx.z * plane;
  const size_t o = blockIdx.z * plane + static_cast<size_t>(y) * W + x;
  if (y < 3 || y >= H - 3 || x < 3 || x >= W - 3) {
    out_ini[o] = 0.0f;
    out_min[o] = 0.0f;
    return;
  }
  // (dx, dy) clockwise from 12 o'clock, the order of fast.py:_CIRCLE
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const float c = img[y * W + x];
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = img[(y + DY[i]) * W + (x + DX[i])] - c;
  float m = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float lo = d[s];
    float hi = d[s];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      lo = fminf(lo, d[(s + j) & 15]);
      hi = fmaxf(hi, d[(s + j) & 15]);
    }
    m = fmaxf(m, fmaxf(lo, -hi));
  }
  out_ini[o] = m > th_ini ? m : 0.0f;
  out_min[o] = m > th_min ? m : 0.0f;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// The caller allocates both outputs; nothing here allocates or syncs.
extern "C" int fast_score_pair_launch(const float* gray, float* out_ini,
                                      float* out_min, int S, int H, int W,
                                      float th_ini, float th_min,
                                      void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8, S);
  fast_score_pair_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      gray, out_ini, out_min, H, W, th_ini, th_min);
  return static_cast<int>(cudaGetLastError());
}
