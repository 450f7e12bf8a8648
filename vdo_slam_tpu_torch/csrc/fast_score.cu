// FAST-9/16 corner score at two thresholds, for every level of an image
// pyramid in one launch, for sm_90a.
//
// Replaces the TPU kernel vdo_slam_tpu/ops/fast_pallas.py:_fast_kernel
// (its launchers _score_pair_single and _score_pair_batched): it computes
// what that kernel computes, not its band-and-DMA structure.
//
// What it computes, per pixel of each level, an fp32 gray image (S, H, W):
//   d_i   = circle_i - centre, i = 0..15 (the radius-3 circle of
//           vdo_slam_tpu/ops/fast.py:_CIRCLE), one fp32 subtraction each;
//   score = max over the 16 contiguous 9-arcs whose d are all > th (or all
//           < -th) of min |d| over the arc, or 0 if no arc qualifies;
//   the 3 px border (y < 3 | y >= H-3 | x < 3 | x >= W-3) is 0.
// The reduction is rewritten without changing a bit of the result:
//   all d > th over an arc   <=>  lo_s = min_arc d       > th
//   all d < -th over an arc  <=>  hi'_s = -max_arc d     > th
// and the arc's score is then lo_s (resp. -max_arc d = min_arc -d).  So with
// M = max(0, max_s lo_s, max_s hi'_s), score(th) = M > th ? M : 0 for any
// th: if any arc qualifies, the largest arc value is > th and qualifies
// too.  Both thresholds then cost one compare each.  Further:
//   * Compass test: any 9 consecutive circle positions hold two adjacent
//     compass points of {0, 4, 8, 12}.  With t = min(th_ini, th_min), a
//     bright arc (all d > t) needs two adjacent compass points with d > t
//     (a bright pair), a dark arc a dark pair.  A pixel with neither has
//     score 0 at both thresholds after 5 loads and 8 compares.
//   * One side at a time: without a dark pair no dark arc qualifies at t,
//     so the dark side's value max(0, max_s hi'_s) <= max(t, 0) cannot be
//     a score above th >= t; likewise for bright.  So only the sides with
//     a pair are computed, and a side's value counts only where it is > t.
//   * Arcs by doubling, on e = d (bright) or e = -d (dark): m2[i] =
//     min(e[i], e[i+1]), m4[i] = min(m2[i], m2[i+2]), m8[i] = min(m4[i],
//     m4[i+4]), arc[i] = min(m8[i], m8[i+1]) (indices mod 16): 80 min/max
//     per side for the 16 arcs, where the arc-by-arc loop took 2 x 128.
// Only subtraction, negation, min, max and compares touch the data, and
// min and max are exact, so the result is bit-equal to the plain PyTorch
// version (ops/fast.py:fast_score).  The thresholds arrive as float and are
// compared as float: a double compare would flip pixels whose difference
// lands exactly on fp32(20/255).
//
// What bounds it on an H100: bytes, in principle.  Per pixel one 4-byte
// read and two 4-byte writes, 17.3 MB for the 8-level pyramid of a
// 1242x375 frame, at least 5.16 us at 3.35 TB/s; the arithmetic above is
// ~1 us of the card's fp32 rate on that frame.  In practice the block
// skeleton (load, compass test, write) takes about twice the byte bound
// and the arcs about as much again (timed on an H100 against cut-down
// copies of this kernel, each missing one phase).  The design:
//   * one launch for all levels: the grid is 1-D over the 32x32 output
//     tiles of every level (blockIdx.y over S), and a block finds its level
//     in the prefix table of FastPyramid, passed by value as a
//     __grid_constant__ parameter, so the launch needs no device-side
//     table, allocates nothing and never synchronises.  The table lists
//     the smallest level first (ops/fast_cuda.py:pyramid_layout), whose
//     blocks have the longest lists, so they do not trail at the end;
//   * each block copies its tile and a 3 px halo (38x38 floats) into shared
//     memory once, with coalesced loads clamped at the image edge (pixels
//     that would read past it are border pixels, whose score is 0 anyway),
//     a thread's 6 loads all issued before its first store; the 16
//     neighbours then come from shared memory;
//   * the compass test puts pixels on per-block bright and dark lists
//     (warp ballots, one shared atomic per warp), and all 256 threads then
//     walk the lists.  Without the lists a warp of 32 pixels runs the arc
//     code if any one of its pixels needs it: on the bench frame 18 % of
//     level 0's pixels pass the compass test but 50 % of its warps hold
//     one, and 66 % / 89 % at level 7;
//   * 32x8 threads, each covering 4 rows of the tile, so a warp writes a
//     128-byte row segment of each output and the halo's cost is spread
//     over 1024 outputs.
// TMA does not fit: a tensor map needs 16-byte row pitches, and the level
// widths (1035, 863, 719, ...) are not multiples of 4 floats.  wgmma does
// not apply to a compare-and-min stencil.

#include <cuda_runtime.h>

#define FAST_MAX_LEVELS 16

// One pyramid level.  The wrapper (ops/fast_cuda.py:_Level, _Pyramid)
// mirrors this layout with ctypes; fast_pyramid_sizeof lets it check that
// the two agree (the size also tells FAST_MAX_LEVELS).
struct FastLevel {
  const float* in;    // (S, H, W), contiguous
  long long out_off;  // offset of the level's th_ini (S, H, W) scores in
                      // out; its th_min scores follow them
  int H, W;
  int tile0;          // index of the level's first tile in the 1-D grid
  int tiles_x;        // tiles per row of the level
};

struct FastPyramid {
  FastLevel lv[FAST_MAX_LEVELS];
  int n_levels;
  float th_ini, th_min;
};

namespace {

constexpr int TILE = 32;              // output tile, TILE x TILE pixels
constexpr int ROWS = 8;               // warps; each covers every ROWS-th row
constexpr int NR = TILE / ROWS;       // rows per thread
constexpr int THREADS = TILE * ROWS;
constexpr int NPIX = TILE * TILE;
constexpr int R = 3;                  // circle radius = halo
constexpr int SIDE = TILE + 2 * R;    // 38: shared tile side
constexpr int LOADS = (SIDE * SIDE + THREADS - 1) / THREADS;  // per thread

// max(0, largest 9-arc minimum of e), the arcs by doubling: m[i] =
// min(e[i..i+7]) in three steps, then arc i = min(m[i], m[i+1]) covers
// e[i..i+8].  Each step overwrites the array the step before it read, so
// no more than two arrays of 16 are live at once.
__device__ __forceinline__ float best_arc(float e[16]) {
  float m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = fminf(e[i], e[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) e[i] = fminf(m[i], m[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = fminf(e[i], e[(i + 4) & 15]);
  float best = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    best = fmaxf(best, fminf(m[i], m[(i + 1) & 15]));
  return best;
}

// One block per 32x32 output tile of one level and one image, a warp per
// 32-pixel row segment.
// Phase 1: the compass test puts each pixel with a bright pair on the
// bright list and each with a dark pair on the dark list (a pixel may be
// on both).  A warp reserves the places of all its listed pixels, of both
// lists, with one shared atomic on a packed count (bright in the low 16
// bits, dark in the high; a list holds at most NPIX < 2^16).  Phase 2: all
// threads walk the lists; M is the largest side value > t, or 0, gathered
// with atomicMax on its bits (a non-negative float orders as its int).
// Phase 3: coalesced writes of both thresholds' scores.
__global__ void __launch_bounds__(THREADS)
fast_pyramid_kernel(const __grid_constant__ FastPyramid p,
                    float* __restrict__ out) {
  __shared__ float tile[SIDE][SIDE];
  __shared__ int best[NPIX];                 // kept M as int bits, or 0
  __shared__ unsigned short todo[2 * NPIX];  // bright list, then dark list
  __shared__ int n_todo;                     // packed list lengths
  // (dx, dy) clockwise from 12 o'clock, the order of fast.py:_CIRCLE; every
  // use is unrolled, so they fold into shared-memory offsets
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

  const int b = blockIdx.x;
  int lv = 0;  // levels after the first whose tiles start at or before b
#pragma unroll
  for (int k = 1; k < FAST_MAX_LEVELS; ++k)
    lv += k < p.n_levels && b >= p.lv[k].tile0;
  const FastLevel& L = p.lv[lv];
  const int t_idx = b - L.tile0;
  const int ty = t_idx / L.tiles_x;
  const int x0 = (t_idx - ty * L.tiles_x) * TILE;
  const int y0 = ty * TILE;
  const int H = L.H, W = L.W;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* img = L.in + blockIdx.y * plane;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * TILE + lane;

  // a thread's loads are all issued before its first store, so they are in
  // flight together
  float v[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int i = min(tid + j * THREADS, SIDE * SIDE - 1);
    const int r = i / SIDE;
    const int gy = min(max(y0 - R + r, 0), H - 1);
    const int gx = min(max(x0 - R + i - r * SIDE, 0), W - 1);
    v[j] = __ldg(img + static_cast<size_t>(gy) * W + gx);
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j)
    if (tid + j * THREADS < SIDE * SIDE)
      (&tile[0][0])[tid + j * THREADS] = v[j];
  if (tid == 0) n_todo = 0;
  __syncthreads();

  const float t = fminf(p.th_ini, p.th_min);
  const int x = x0 + lane;
  const bool x_in = x >= R && x < W - R;
  unsigned bright_rows[NR], dark_rows[NR];
  int n_warp = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int ly = threadIdx.y + r * ROWS;
    const int y = y0 + ly;
    best[ly * TILE + lane] = 0;
    bool bright = false, dark = false;
    if (x_in && y >= R && y < H - R) {
      const int cy = ly + R, cx = lane + R;
      const float c = tile[cy][cx];
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        d[k] = tile[cy + DY[4 * k]][cx + DX[4 * k]] - c;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bright |= d[k] > t && d[(k + 1) & 3] > t;
        dark |= d[k] < -t && d[(k + 1) & 3] < -t;
      }
    }
    bright_rows[r] = __ballot_sync(0xffffffffu, bright);
    dark_rows[r] = __ballot_sync(0xffffffffu, dark);
    n_warp += __popc(bright_rows[r]) + (__popc(dark_rows[r]) << 16);
  }
  int at = 0;
  if (lane == 0 && n_warp) at = atomicAdd(&n_todo, n_warp);
  at = __shfl_sync(0xffffffffu, at, 0);
  int at_bright = at & 0xffff, at_dark = NPIX + (at >> 16);
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = (threadIdx.y + r * ROWS) * TILE + lane;
    if (bright_rows[r] >> lane & 1)
      todo[at_bright + __popc(bright_rows[r] & below)] = i;
    if (dark_rows[r] >> lane & 1)
      todo[at_dark + __popc(dark_rows[r] & below)] = i;
    at_bright += __popc(bright_rows[r]);
    at_dark += __popc(dark_rows[r]);
  }
  __syncthreads();

  const int n_bright = n_todo & 0xffff;
  const int n_all = n_bright + (n_todo >> 16);
  for (int k = tid; k < n_all; k += THREADS) {
    const bool is_bright = k < n_bright;
    const int i = todo[is_bright ? k : NPIX + k - n_bright];
    const int cy = i / TILE + R, cx = i % TILE + R;
    const float c = tile[cy][cx];
    float e[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float d = tile[cy + DY[j]][cx + DX[j]] - c;
      e[j] = is_bright ? d : -d;
    }
    const float m = best_arc(e);
    if (m > t) atomicMax(&best[i], __float_as_int(m));
  }
  __syncthreads();

  float* o_ini = out + L.out_off + blockIdx.y * plane;
  float* o_min = o_ini + gridDim.y * plane;
  if (x >= W) return;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int ly = threadIdx.y + r * ROWS;
    const int y = y0 + ly;
    if (y >= H) break;
    const float m = __int_as_float(best[ly * TILE + lane]);
    const size_t o = static_cast<size_t>(y) * W + x;
    o_ini[o] = m > p.th_ini ? m : 0.0f;
    o_min[o] = m > p.th_min ? m : 0.0f;
  }
}

}  // namespace

extern "C" int fast_pyramid_sizeof() {
  return static_cast<int>(sizeof(FastPyramid));
}

// Launches on `stream` over n_tiles x S blocks and returns
// cudaGetLastError() as an int (0 = ok).  `out` holds, level after level,
// the level's (S, H, W) th_ini scores, then its th_min scores.  The caller
// allocates it; nothing here allocates or syncs.
extern "C" int fast_score_pyramid_launch(FastPyramid p, int n_tiles, int S,
                                         float* out, void* stream) {
  if (p.n_levels < 1 || p.n_levels > FAST_MAX_LEVELS || n_tiles < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(TILE, ROWS);
  const dim3 grid(n_tiles, S);
  fast_pyramid_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out);
  return static_cast<int>(cudaGetLastError());
}
