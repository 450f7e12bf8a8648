// The Hessian-vector product of the full BA's PCG, H t = J^T W J t, one
// launch per edge type, the per-vertex pass beside it (the damping term of
// the product, the block-Jacobi preconditioner's apply), and the
// linearisation and evaluation of the observation and ternary edges that
// PCG's normal equations come from (below).
//
// Replaces no Pallas kernel: the JAX package leaves _matvec to XLA
// (vdo_slam_tpu/backend/factor_graph.py), which fuses its per-edge einsums
// and segment sums on the TPU.  Run op by op on this card the same product
// was ~60 ops a matvec: a gather of tangent rows, a cuBLAS batched gemv of
// one 3x6 matrix per batch entry (latency-bound), a weight product, an
// index_add_ into a fresh buffer and a fresh add, each product written to
// device memory and read back.
//
// Bound by bytes: every edge's indices, weight and Jacobian blocks are read
// once a matvec (~1.07 GB at the 1,028-frame refine's caps, ~0.32 ms at
// 3.35 TB/s); the tangent rows it gathers and the rows it writes are small
// beside them.  One thread takes one edge: it loads the edge's weight, and
// where that is not 0 its indices and blocks, gathers its incident tangent
// rows, forms u = w sum_k J_k x_k and y_k = J_k^T u in registers, and
// scatters each y_k into its vertex's row, with nothing per edge written to
// device memory.  A zero-weight edge (the builders' padding up to the caps)
// adds nothing to the product, so nothing of it but its weight is read.
// The scatter:
//   * every incidence first sums runs of equal index among a warp's 32
//     consecutive edges (a segmented suffix sum by shuffles), and only a
//     run's first lane adds: the builders sort obs_point, ter_prev and
//     ter_cur (backend/builders.py), so runs are common there; a sum of 0
//     adds nothing;
//   * the one unsorted incidence with few rows (obs_pose: F rows; ter_mot:
//     M rows) adds into a block-private copy of its rows in shared memory,
//     flushed at the block's end with one global atomic per touched entry;
//     the grid is a few blocks per SM, so the flushes stay few.  Where the
//     rows do not
//     fit HV_SMEM_BUDGET the same incidence adds into global memory: the
//     launch picks the kernel from the shape;
//   * the blocks take tiles of HV_THREADS consecutive edges in turn (tile
//     b, b + grid, ...): the padding edges, which fill each array's end,
//     spread over every block, and the blocks at work at one time read
//     one narrow stretch of the sorted point rows;
//   * everything else adds into global memory with atomicAdd.
// Float atomics make the summation order change from run to run, as
// index_add_'s did.
//
// Each Jacobian block is read through its three strides (edge, row, column)
// as the linearisation leaves it: a transposed view needs no copy, and an
// expanded identity (edge stride 0) reads the same 36 bytes for every edge.
//
// The vertex pass is one launch over the three vertex kinds (poses,
// motions, points): y = d * x elementwise (y = 0 where d is absent), or
// y = A x with a (W, W) block per row read through its strides
// (the inverted block-Jacobi blocks, in whatever layout the batched inverse
// left them).
//
// The linearisation of the two large edge types around PCG, one launch per
// type: the observations (inv(T) X - z) and the ternary motion edges
// (X_prev - inv(H) X_cur), 99.9 % of the refine's edges.  It too replaces
// no Pallas kernel: the JAX package leaves residuals, _linearize,
// _gradient and _block_diag to XLA's fusion.  Op by op on this card they
// were cuBLAS batched gemv and gemm of one 3x3, 3x6 or 4x4 matrix per
// batch entry, gathers, cats and index_add_, each result written to device
// memory and read back: ~0.49 s of the refine's ~0.58 s LM.  Bound by
// bytes: a live obs edge reads its indices, measurement, weight and point
// (44 B) and writes its IRLS weight and two Jacobian blocks (112 B), a
// live ter edge reads 52 B and writes 112 B, and the per-vertex rows add
// ~0.15 GB: ~1.1-1.2 GB a linearisation at the refine's caps, ~0.35 ms at
// 3.35 TB/s.  One thread takes one edge: it reads the edge's weight, and
// where that is not 0 gathers its pose or motion and points, forms the
// residual, the Huber IRLS weight and the Jacobian blocks in registers,
// writes the weight and the blocks (a zero-weight edge writes weight 0 and
// nothing else), and adds J^T w r into the gradient rows and the upper
// triangle of J^T w J into the block-diagonal rows of its vertices (21 of
// 36 entries of a 6x6 block, 6 of 9 of a 3x3), through the product's
// scatter: warp-run sums on the sorted point incidences, the obs pose rows
// in block-private shared memory where F rows fit HV_SMEM_BUDGET, global
// atomics elsewhere (the ter motion rows: 3,712 of 27 entries do not fit).
// One vertex pass then copies each block's upper triangle into its lower.
// The blocks are written where the product reads them, through the
// strides it takes: the wrapper lays them out component by component
// (edge stride 1), so that both kernels read and write them coalesced.
// The evaluation is the same residual without the Jacobians: per type the
// robust cost's rho summed, and the active edges' chi2 summed and counted
// with their inliers, each thread's sums added over its block, then one
// atomic per block: ~0.3 GB a pass.  The counts are exact; the order in
// which the blocks' float sums (and every float atomic above) land changes
// from run to run, so the cost, chi2, gradient and blocks differ between
// runs of one input in their last bits, and an LM step whose cost nearly
// ties the last may be accepted in one run and refused in another.  PCG's
// product sums with atomics too, so the refine's steps already differed
// so; the plain version on the CPU is deterministic.
//
// Built by nvcc into a shared library with a plain C interface, bound with
// ctypes by ops/edge_hessian_cuda.py.  The launches allocate nothing and do
// not synchronise; each returns cudaGetLastError().

#include <cuda_runtime.h>

#define HV_THREADS 256
// shared memory a block may hold for its private rows: two such blocks fit
// one SM's 228 KB
#define HV_SMEM_BUDGET 114688
#define HV_MAX_INC 3

struct HvInc {
  const float* J;        // (E, R, W) block, element strides below
  long long sJ[3];       // edge, row, column
  const long long* idx;  // (E,) vertex row of each edge
  const float* x;        // (n_rows, W) contiguous: the tangent's rows
  float* y;              // (n_rows, W) contiguous: the product's rows
  long long n_rows;
};

struct HvEdges {
  HvInc inc[HV_MAX_INC];
  const float* w;        // (E,) IRLS-weighted information weight
  long long n_edges;
};

struct VxSeg {
  const float* A;        // (n, w, w) blocks, or null
  long long sA[3];       // row, block row, block column
  const float* d;        // (n, w) contiguous, or null
  const float* x;        // (n, w) contiguous
  float* y;              // (n, w) contiguous
  long long n;
  int w;
};

struct VxArgs {
  VxSeg seg[3];
};

extern __shared__ float hv_rows[];

__host__ __device__ constexpr int pick(int k, int a, int b, int c) {
  return k == 0 ? a : (k == 1 ? b : c);
}

template <int R, int W>
__device__ __forceinline__ void load_block(const HvInc& in, long long e,
                                           float (&J)[R][W]) {
  const float* p = in.J + e * in.sJ[0];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < W; ++c)
      J[r][c] = __ldg(p + r * in.sJ[1] + c * in.sJ[2]);
}

// u += J x[id]
template <int R, int W>
__device__ __forceinline__ void add_jx(const float (&J)[R][W],
                                       const float* __restrict__ x,
                                       long long id, float (&u)[R]) {
  float xv[W];
#pragma unroll
  for (int c = 0; c < W; ++c) xv[c] = __ldg(x + id * W + c);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < W; ++c) u[r] = fmaf(J[r][c], xv[c], u[r]);
}

// Sums v over each run of equal id among the warp's lanes (a segmented
// suffix sum by shuffles) into the run's first lane; returns whether this
// lane is a run's first and has an edge (id >= 0: a lane with no edge, or
// with an edge of weight 0, passes -1).  Every lane of the warp calls this.
template <int NV>
__device__ __forceinline__ bool run_sum(float (&v)[NV], long long id,
                                        int lane) {
  const unsigned full = 0xffffffffu;
  const long long prev = __shfl_up_sync(full, id, 1);
  const bool head = lane == 0 || prev != id;
  const unsigned heads = __ballot_sync(full, head);
  if (heads != full) {  // some run is longer than one lane
    const unsigned later = lane == 31 ? 0u : heads & (full << (lane + 1));
    const int last = later ? __ffs(later) - 2 : 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float o = __shfl_down_sync(full, v[c], off);
        if (lane + off <= last) v[c] += o;
      }
    }
  }
  return head && id >= 0;
}

// y = J^T u on live lanes, 0 elsewhere; then summed over each run of equal
// id (run_sum) and added into row id by the run's first lane (into the
// block's shared rows where SHARED), each entry that is not 0: adding 0
// changes nothing.
template <int R, int W, bool SHARED>
__device__ __forceinline__ void scatter(const float (&J)[R][W],
                                        const float (&u)[R], bool live,
                                        long long id, float* __restrict__ y,
                                        int lane) {
  float v[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) s = fmaf(J[r][c], u[r], s);
    v[c] = live ? s : 0.f;
  }
  if (run_sum<W>(v, id, lane)) {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (v[c] == 0.f) continue;  // adds nothing: the padding edges' runs
      if constexpr (SHARED) {
        atomicAdd(&hv_rows[id * W + c], v[c]);
      } else {
        atomicAdd(&y[id * W + c], v[c]);
      }
    }
  }
}

// One edge type: R residual rows, NI incidences of widths W0..W2, SH the
// incidence whose rows live in shared memory (-1: none).  Block b takes
// the tiles of HV_THREADS edges b, b + gridDim.x, ...
template <int R, int NI, int W0, int W1, int W2, int SH>
__global__ void __launch_bounds__(HV_THREADS) edge_hv_kernel(const HvEdges a) {
  constexpr int WSH = pick(SH < 0 ? 0 : SH, W0, W1, W2);
  const int lane = threadIdx.x & 31;
  const long long end = a.n_edges;
  const long long step = (long long)gridDim.x * HV_THREADS;
  long long n_sh = 0;
  if constexpr (SH >= 0) {
    n_sh = a.inc[SH].n_rows * WSH;
    for (long long i = threadIdx.x; i < n_sh; i += blockDim.x)
      hv_rows[i] = 0.f;
    __syncthreads();
  }
  for (long long base = (long long)blockIdx.x * HV_THREADS; base < end;
       base += step) {
    const long long e = base + threadIdx.x;
    const float w = e < end ? __ldg(a.w + e) : 0.f;
    const bool live = w != 0.f;
    float J0[R][W0], J1[R][W1], J2[R][W2];
    long long i0 = -1, i1 = -1, i2 = -1;
    float u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = 0.f;
    if (live) {
      i0 = a.inc[0].idx[e];
      load_block<R, W0>(a.inc[0], e, J0);
      add_jx<R, W0>(J0, a.inc[0].x, i0, u);
      if constexpr (NI > 1) {
        i1 = a.inc[1].idx[e];
        load_block<R, W1>(a.inc[1], e, J1);
        add_jx<R, W1>(J1, a.inc[1].x, i1, u);
      }
      if constexpr (NI > 2) {
        i2 = a.inc[2].idx[e];
        load_block<R, W2>(a.inc[2], e, J2);
        add_jx<R, W2>(J2, a.inc[2].x, i2, u);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) u[r] *= w;
    }
    scatter<R, W0, SH == 0>(J0, u, live, i0, a.inc[0].y, lane);
    if constexpr (NI > 1) scatter<R, W1, SH == 1>(J1, u, live, i1, a.inc[1].y, lane);
    if constexpr (NI > 2) scatter<R, W2, SH == 2>(J2, u, live, i2, a.inc[2].y, lane);
  }
  if constexpr (SH >= 0) {
    __syncthreads();
    float* y = a.inc[SH].y;
    for (long long i = threadIdx.x; i < n_sh; i += blockDim.x) {
      const float v = hv_rows[i];
      if (v != 0.f) atomicAdd(y + i, v);
    }
  }
}

// kernel(a) over n_edges edges: a grid of at most as many blocks of
// HV_THREADS as are resident on the card at once (the blocks walk the
// tiles grid-stride), each with smem bytes of dynamic shared memory (the
// kernel's limit raised to HV_SMEM_BUDGET where smem is not 0).
template <typename Args>
static int launch_grid(void (*kernel)(const Args), const Args& a,
                       long long n_edges, size_t smem, cudaStream_t stream) {
  if (n_edges <= 0) return cudaSuccess;
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HV_SMEM_BUDGET);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        HV_THREADS, smem);
  if (err != cudaSuccess) return err;
  const long long want = (n_edges + HV_THREADS - 1) / HV_THREADS;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * n_sm;
  const long long grid = want < cap ? want : cap;
  kernel<<<(unsigned)grid, HV_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// One edge type's launch: SH is the incidence whose rows a block keeps in
// shared memory where they fit HV_SMEM_BUDGET (-1: none); where they do
// not, the kernel that adds them into global memory.
template <int R, int NI, int W0, int W1, int W2, int SH>
static int launch_edges(const HvEdges& a, cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (SH >= 0) {
    smem = (size_t)a.inc[SH].n_rows * pick(SH, W0, W1, W2) * sizeof(float);
    if (smem > HV_SMEM_BUDGET)
      return launch_edges<R, NI, W0, W1, W2, -1>(a, stream);
  }
  return launch_grid(edge_hv_kernel<R, NI, W0, W1, W2, SH>, a, a.n_edges,
                     smem, stream);
}

template <int W>
__device__ __forceinline__ float block_row(const VxSeg& g, long long row,
                                           int i) {
  const float* A = g.A + row * g.sA[0] + i * g.sA[1];
  const float* x = g.x + row * W;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j) s = fmaf(__ldg(A + j * g.sA[2]), __ldg(x + j), s);
  return s;
}

__device__ __forceinline__ void vertex_one(const VxSeg& g, long long k) {
  float v;
  if (g.A != nullptr) {
    const long long row = k / g.w;
    const int i = (int)(k - row * g.w);
    v = g.w == 6 ? block_row<6>(g, row, i) : block_row<3>(g, row, i);
  } else {
    v = g.d != nullptr ? __ldg(g.d + k) * __ldg(g.x + k) : 0.f;
  }
  g.y[k] = v;
}

// one thread per output entry of the three kinds, back to back
__global__ void vertex_kernel(const VxArgs a, const long long n0,
                              const long long n1, const long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    if (e < n0)
      vertex_one(a.seg[0], e);
    else if (e < n0 + n1)
      vertex_one(a.seg[1], e - n0);
    else
      vertex_one(a.seg[2], e - n0 - n1);
  }
}

// ---------------------------------------------------------------------------
// The linearisation and the evaluation of the two large edge types: the
// observations (variant LIN_OBS: incidences pose, point) and the ternary
// motion edges (LIN_TER: prev point, cur point, motion).

#define LIN_OBS 0
#define LIN_TER 1

struct LinArgs {
  const float* w;             // (E,) information weight
  const long long* idx[3];    // (E,) vertex row of each incidence
  const float* T;             // (n, 4, 4) contiguous: poses (obs), motions (ter)
  const float* X;             // (P, 3) contiguous points
  const float* meas;          // (E, 3) contiguous measurements (obs)
  float* w_out;               // (E,) IRLS-weighted weight
  float* J[3];                // (E, 3, W) blocks, element strides below;
  long long sJ[3][3];         //   null: not written (ter's prev identity)
  float* grad[3];             // (n_rows, W) contiguous gradient rows
  float* diag[3];             // (n_rows, W, W) contiguous blocks: upper
  long long n_rows[3];        //   triangle added, mirrored by mirror_kernel
  float* sums;                // (2,) the evaluation's rho and active chi2
  unsigned long long* counts; // (2,) its active and inlier edges (int64)
  long long n_edges;
  float delta, delta2, two_delta;  // Huber delta, delta^2, 2 delta
  int robust;
};

// what one edge's residual leaves for its Jacobians
struct EdgeGeom {
  long long id[3];
  float R[3][3];  // rotation of the pose (obs) or the motion (ter)
  float p[3];     // inv(T) X: the camera-frame point Y (obs), Z (ter)
  float r[3];     // residual
};

// The residual as factor_graph's `residuals` forms it: obs inv(T) X - z,
// ter X_prev - inv(H) X_cur, with inv(T) X = R^T X + (-(R^T t)) as
// se3.inv and se3.apply form it.
template <int TYPE>
__device__ __forceinline__ void edge_geom(const LinArgs& a, long long e,
                                          EdgeGeom& g) {
  g.id[0] = a.idx[0][e];
  g.id[1] = a.idx[1][e];
  g.id[2] = TYPE == LIN_TER ? a.idx[2][e] : -1;
  const float* T = a.T + 16 * (TYPE == LIN_OBS ? g.id[0] : g.id[2]);
  const float* X = a.X + 3 * g.id[1];
  float t[3], x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) g.R[i][j] = __ldg(T + 4 * i + j);
    t[i] = __ldg(T + 4 * i + 3);
    x[i] = __ldg(X + i);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float rx = 0.f, rt = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rx = fmaf(g.R[j][i], x[j], rx);
      rt = fmaf(g.R[j][i], t[j], rt);
    }
    g.p[i] = rx - rt;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    g.r[i] = TYPE == LIN_OBS ? g.p[i] - __ldg(a.meas + 3 * e + i)
                             : __ldg(a.X + 3 * g.id[0] + i) - g.p[i];
}

// w |r|^2, rounded as factor_graph's _chi2 rounds it (no fused products)
__device__ __forceinline__ float chi2_of(const float (&r)[3], float w) {
  return __fmul_rn(w, __fadd_rn(__fadd_rn(__fmul_rn(r[0], r[0]),
                                          __fmul_rn(r[1], r[1])),
                                __fmul_rn(r[2], r[2])));
}

// s [hat(p) | -I]: the obs pose block (s = 1) and the ter motion block
// (s = -1, [-hat(p) | I])
__device__ __forceinline__ void hat_block(const float (&p)[3], float s,
                                          float (&J)[3][6]) {
  const float h[3][3] = {{0.f, -p[2], p[1]}, {p[2], 0.f, -p[0]},
                         {-p[1], p[0], 0.f}};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J[r][c] = s * h[r][c];
      J[r][c + 3] = r == c ? -s : 0.f;
    }
}

template <int W>
__device__ __forceinline__ void store_block(float* J, const long long (&sJ)[3],
                                            long long e,
                                            const float (&B)[3][W]) {
  float* p = J + e * sJ[0];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < W; ++c) p[r * sJ[1] + c * sJ[2]] = B[r][c];
}

// entries of a row: W of the gradient, W (W + 1) / 2 of the block's upper
// triangle (row by row)
template <int W>
__host__ __device__ constexpr int n_terms() { return W + W * (W + 1) / 2; }

// offset in the (W, W) block of the k-th upper-triangle entry
template <int W>
__host__ __device__ constexpr int upper_offset(int k) {
  int i = 0;
  while (k >= W - i) {
    k -= W - i;
    ++i;
  }
  return i * W + i + k;
}

// v = (J^T u, the upper triangle of J^T J wr) with u = r wr, as
// factor_graph's _gradient and _block_diag form them per edge
template <int W>
__device__ __forceinline__ void normal_terms(const float (&J)[3][W],
                                             const float (&r)[3], float wr,
                                             float (&v)[n_terms<W>()]) {
  float u[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) u[k] = r[k] * wr;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) s = fmaf(J[k][c], u[k], s);
    v[c] = s;
  }
  int n = W;
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = i; j < W; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) s = fmaf(J[k][i], J[k][j], s);
      v[n++] = s * wr;
    }
}

// One incidence's terms (0 on lanes that are not live), summed over runs of
// equal id (run_sum) and added by each run's first lane into its vertex's
// gradient row and block (into the block's shared rows where SHARED), each
// entry that is not 0.  Every lane of the warp calls this.
template <int W, bool SHARED>
__device__ __forceinline__ void add_terms(float (&v)[n_terms<W>()], bool live,
                                          long long id, float* grad,
                                          float* diag, int lane) {
  constexpr int NV = n_terms<W>();
  if (!live) {
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = 0.f;
  }
  if (!run_sum<NV>(v, id, lane)) return;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (v[k] == 0.f) continue;
    if constexpr (SHARED) {
      atomicAdd(&hv_rows[id * NV + k], v[k]);
    } else if (k < W) {
      atomicAdd(grad + id * W + k, v[k]);
    } else {
      atomicAdd(diag + id * W * W + upper_offset<W>(k - W), v[k]);
    }
  }
}

// The linearisation of one edge type: one thread an edge, the blocks of
// the block walking tiles of HV_THREADS consecutive edges grid-stride; SH
// the incidence whose rows (gradient and upper triangle, n_terms a row) a
// block keeps in shared memory (-1: none).
template <int TYPE, int SH>
__global__ void __launch_bounds__(HV_THREADS, 2)
    edge_lin_kernel(const LinArgs a) {
  constexpr int WSH = SH == 0 || SH == 2 ? 6 : 3;
  constexpr int NSH = n_terms<WSH>();
  const int lane = threadIdx.x & 31;
  const long long end = a.n_edges;
  const long long step = (long long)gridDim.x * HV_THREADS;
  long long n_sh = 0;
  if constexpr (SH >= 0) {
    n_sh = a.n_rows[SH] * NSH;
    for (long long i = threadIdx.x; i < n_sh; i += blockDim.x)
      hv_rows[i] = 0.f;
    __syncthreads();
  }
  for (long long base = (long long)blockIdx.x * HV_THREADS; base < end;
       base += step) {
    const long long e = base + threadIdx.x;
    const float w = e < end ? __ldg(a.w + e) : 0.f;
    const bool live = w != 0.f;
    EdgeGeom g{};  // zeros on a lane that is not live
    g.id[0] = g.id[1] = g.id[2] = -1;
    float wr = 0.f;
    if (live) {
      edge_geom<TYPE>(a, e, g);
      const float c = chi2_of(g.r, w);
      wr = a.robust && !(c <= a.delta2)
               ? __fmul_rn(w, __fdiv_rn(a.delta, sqrtf(fmaxf(c, 1e-24f))))
               : w;
    }
    if (e < end) a.w_out[e] = wr;
    if constexpr (TYPE == LIN_OBS) {
      float Jp[3][6], Jx[3][3];
      hat_block(g.p, 1.f, Jp);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) Jx[r][c] = g.R[c][r];  // R^T
      if (live) {
        store_block<6>(a.J[0], a.sJ[0], e, Jp);
        store_block<3>(a.J[1], a.sJ[1], e, Jx);
      }
      float vp[n_terms<6>()], vx[n_terms<3>()];
      normal_terms<6>(Jp, g.r, wr, vp);
      add_terms<6, SH == 0>(vp, live, g.id[0], a.grad[0], a.diag[0], lane);
      normal_terms<3>(Jx, g.r, wr, vx);
      add_terms<3, false>(vx, live, g.id[1], a.grad[1], a.diag[1], lane);
    } else {
      float Ji[3][3], Jc[3][3], Jm[3][6];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          Ji[r][c] = r == c ? 1.f : 0.f;
          Jc[r][c] = -g.R[c][r];  // -R^T
        }
      hat_block(g.p, -1.f, Jm);
      if (live) {
        store_block<3>(a.J[1], a.sJ[1], e, Jc);
        store_block<6>(a.J[2], a.sJ[2], e, Jm);
      }
      float vi[n_terms<3>()], vc[n_terms<3>()], vm[n_terms<6>()];
      normal_terms<3>(Ji, g.r, wr, vi);
      add_terms<3, false>(vi, live, g.id[0], a.grad[0], a.diag[0], lane);
      normal_terms<3>(Jc, g.r, wr, vc);
      add_terms<3, false>(vc, live, g.id[1], a.grad[1], a.diag[1], lane);
      normal_terms<6>(Jm, g.r, wr, vm);
      add_terms<6, SH == 2>(vm, live, g.id[2], a.grad[2], a.diag[2], lane);
    }
  }
  if constexpr (SH >= 0) {
    __syncthreads();
    for (long long i = threadIdx.x; i < n_sh; i += blockDim.x) {
      const float v = hv_rows[i];
      if (v == 0.f) continue;
      const long long row = i / NSH;
      const int k = (int)(i - row * NSH);
      atomicAdd(k < WSH ? a.grad[SH] + row * WSH + k
                        : a.diag[SH] + row * WSH * WSH +
                              upper_offset<WSH>(k - WSH),
                v);
    }
  }
}

// The evaluation of one edge type: the robust cost's rho summed over its
// edges, and chi2 summed over, and counted for, its active edges (weight
// above 0) and inliers (chi2 <= delta^2), as factor_graph's robust_cost
// and edge_type_stats form them; one thread per edge, grid-stride, summed
// over the block, then one atomic per block and sum.
template <int TYPE>
__global__ void __launch_bounds__(HV_THREADS) edge_eval_kernel(
    const LinArgs a) {
  __shared__ float part_f[HV_THREADS / 32][2];
  __shared__ unsigned part_n[HV_THREADS / 32][2];
  float rho = 0.f, chi = 0.f;
  unsigned n = 0, n_in = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < a.n_edges; e += stride) {
    const float w = __ldg(a.w + e);
    if (w == 0.f) continue;  // adds 0 to each sum, counts in neither
    EdgeGeom g;
    edge_geom<TYPE>(a, e, g);
    const float c = chi2_of(g.r, w);
    const bool in = c <= a.delta2;
    rho += a.robust && !in
               ? __fsub_rn(__fmul_rn(a.two_delta, sqrtf(fmaxf(c, 1e-24f))),
                           a.delta2)
               : c;
    if (w > 0.f) {
      chi += c;
      ++n;
      n_in += in;
    }
  }
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rho += __shfl_down_sync(full, rho, off);
    chi += __shfl_down_sync(full, chi, off);
    n += __shfl_down_sync(full, n, off);
    n_in += __shfl_down_sync(full, n_in, off);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part_f[warp][0] = rho;
    part_f[warp][1] = chi;
    part_n[warp][0] = n;
    part_n[warp][1] = n_in;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < HV_THREADS / 32; ++k) {
      rho += part_f[k][0];
      chi += part_f[k][1];
      n += part_n[k][0];
      n_in += part_n[k][1];
    }
    if (rho != 0.f) atomicAdd(a.sums, rho);
    if (chi != 0.f) atomicAdd(a.sums + 1, chi);
    if (n) atomicAdd(a.counts, (unsigned long long)n);
    if (n_in) atomicAdd(a.counts + 1, (unsigned long long)n_in);
  }
}

// One edge type's linearisation: SH the incidence whose rows a block keeps
// in shared memory where they fit HV_SMEM_BUDGET, else the kernel that
// adds them into global memory.
template <int TYPE, int SH>
static int launch_lin(const LinArgs& a, cudaStream_t stream) {
  constexpr int W = 6;  // obs pose rows, ter motion rows
  const size_t smem = (size_t)a.n_rows[SH] * n_terms<W>() * sizeof(float);
  if (smem > HV_SMEM_BUDGET)
    return launch_grid(edge_lin_kernel<TYPE, -1>, a, a.n_edges, 0, stream);
  return launch_grid(edge_lin_kernel<TYPE, SH>, a, a.n_edges, smem, stream);
}

// the lower triangle of each (w, w) block of the three kinds copied from
// its upper: one thread per lower entry, the kinds back to back
__global__ void mirror_kernel(const VxArgs a, const long long n0,
                              const long long n1, const long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int s = e < n0 ? 0 : (e < n0 + n1 ? 1 : 2);
    const VxSeg& g = a.seg[s];
    const long long k = e - (s > 0 ? n0 : 0) - (s > 1 ? n1 : 0);
    const int lower = g.w * (g.w - 1) / 2;
    const long long row = k / lower;
    int l = (int)(k - row * lower), i = 1;
    while (l >= i) {
      l -= i;
      ++i;
    }
    float* D = g.y + row * g.w * g.w;
    D[i * g.w + l] = D[l * g.w + i];
  }
}

extern "C" {

int edge_hv_sizeof_edges() { return (int)sizeof(HvEdges); }
int edge_hv_sizeof_vertex() { return (int)sizeof(VxArgs); }
int edge_lin_sizeof_args() { return (int)sizeof(LinArgs); }

// variant: 0 obs (pose rows in shared memory where they fit), 1 ter
// (motion rows likewise), 2 odo and smo, 3 pri, 4 alt; the incidences in
// the order of ops/edge_hessian_cuda.py:INCIDENCE
int edge_hv_launch(int variant, HvEdges a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch_edges<3, 2, 6, 3, 1, 0>(a, s);
    case 1: return launch_edges<3, 3, 3, 3, 6, 2>(a, s);
    case 2: return launch_edges<6, 2, 6, 6, 1, -1>(a, s);
    case 3: return launch_edges<6, 1, 6, 1, 1, -1>(a, s);
    case 4: return launch_edges<1, 1, 6, 1, 1, -1>(a, s);
  }
  return cudaErrorInvalidValue;
}

int vertex_pass_launch(VxArgs a, void* stream) {
  const long long n0 = a.seg[0].n * a.seg[0].w;
  const long long n1 = a.seg[1].n * a.seg[1].w;
  const long long total = n0 + n1 + a.seg[2].n * a.seg[2].w;
  if (total <= 0) return cudaSuccess;
  long long blocks = (total + 255) / 256;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  vertex_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      a, n0, n1, total);
  return cudaGetLastError();
}

// variant: 0 obs (pose rows in shared memory where they fit), 1 ter
// (motion rows likewise); evaluate: 0 the linearisation, 1 the evaluation
int edge_lin_launch(int variant, int evaluate, LinArgs a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == LIN_OBS)
    return evaluate ? launch_grid(edge_eval_kernel<LIN_OBS>, a, a.n_edges, 0, s)
                    : launch_lin<LIN_OBS, 0>(a, s);
  if (variant == LIN_TER)
    return evaluate ? launch_grid(edge_eval_kernel<LIN_TER>, a, a.n_edges, 0, s)
                    : launch_lin<LIN_TER, 2>(a, s);
  return cudaErrorInvalidValue;
}

// the blocks y of each segment, (n, w, w) contiguous, made symmetric from
// their upper triangles
int mirror_launch(VxArgs a, void* stream) {
  long long n[3];
  for (int k = 0; k < 3; ++k) n[k] = a.seg[k].n * (a.seg[k].w * (a.seg[k].w - 1) / 2);
  const long long total = n[0] + n[1] + n[2];
  if (total <= 0) return cudaSuccess;
  long long blocks = (total + 255) / 256;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  mirror_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      a, n[0], n[1], total);
  return cudaGetLastError();
}

}  // extern "C"
