// The Hessian-vector product of the full BA's PCG, H t = J^T W J t, one
// launch per edge type, and the per-vertex pass beside it (the damping
// term of the product, the block-Jacobi preconditioner's apply).
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

// y = J^T u on live lanes, 0 elsewhere; then summed over each run of equal
// id among the warp's lanes and added into row id by the run's first lane
// (into the block's shared rows where SHARED), each entry that is not 0:
// adding 0 changes nothing.  id < 0 marks a lane with no edge, or with an
// edge of weight 0.  Every lane of the warp calls this.
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
      for (int c = 0; c < W; ++c) {
        const float o = __shfl_down_sync(full, v[c], off);
        if (lane + off <= last) v[c] += o;
      }
    }
  }
  if (head && id >= 0) {
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

// One edge type's launch: SH is the incidence whose rows a block keeps in
// shared memory where they fit HV_SMEM_BUDGET (-1: none); where they do
// not, the kernel that adds them into global memory.
template <int R, int NI, int W0, int W1, int W2, int SH>
static int launch_edges(const HvEdges& a, cudaStream_t stream) {
  if (a.n_edges <= 0) return cudaSuccess;
  size_t smem = 0;
  if constexpr (SH >= 0) {
    smem = (size_t)a.inc[SH].n_rows * pick(SH, W0, W1, W2) * sizeof(float);
    if (smem > HV_SMEM_BUDGET)
      return launch_edges<R, NI, W0, W1, W2, -1>(a, stream);
  }
  auto kernel = edge_hv_kernel<R, NI, W0, W1, W2, SH>;
  if constexpr (SH >= 0) {
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
  const long long want = (a.n_edges + HV_THREADS - 1) / HV_THREADS;
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * n_sm;
  const long long grid = want < cap ? want : cap;
  kernel<<<(unsigned)grid, HV_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
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

extern "C" {

int edge_hv_sizeof_edges() { return (int)sizeof(HvEdges); }
int edge_hv_sizeof_vertex() { return (int)sizeof(VxArgs); }

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

}  // extern "C"
