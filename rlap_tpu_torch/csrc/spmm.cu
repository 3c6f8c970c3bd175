// SpMM as a segment-sum over sorted edges, for the GCN and GIN encoders.
//
// It replaces no TPU kernel: the JAX package's `spmm` (rlap_tpu/ops/spmm.py)
// is XLA's gather and segment-sum. It replaces the port's plain body of
// `rlap_tpu_torch/ops/spmm.py::spmm` on the card (`spmm_plain`: gather,
// scale, `index_add`), whose backward is PyTorch's sort-based
// `index_put_(accumulate=True)`: every padding slot of a view reads and
// writes the one sentinel row n, and that kernel walks their run of equal
// indices serially.
//
//   out[i] = sum over k in [rowptr[i], rowptr[i + 1]) of w[k] * x[col[k]]
//
// for i in [0, n): the edges sorted by the segment they sum into (the
// receiver in the forward, the sender in the backward, which gathers the
// output's gradient by receiver). The wrapper builds rowptr, col and w on
// the card; padding edges (sender == receiver == n) all lie in segment n,
// which the grid does not cover, so no padding slot is read. An edge whose
// gathered endpoint is n contributes nothing. Each output row is summed in
// registers in its dtype (float32 or float64) in a fixed order and written
// once: no atomics, and the same inputs give the same bits. The order is
// edge order, except in a row of more than LONG edges: there eight
// contiguous slices are each summed in edge order, then added in turn.
//
// Bound: the bytes of the gathered rows. A row of x is read once for each
// edge that gathers it (E * F values, 1.3 GB a call at E = 2.5 M, F = 128
// in float32), against n * F of output; the 50 MB L2 serves the repeats it
// holds. The design keeps as many of those reads in flight as it can: one
// warp a row, its lanes over the features in 16-byte loads, U edges'
// loads issued before their sums; the row's column indices and weights are
// read 32 at a time, coalesced, the next 32 while the current are summed,
// and broadcast by shuffles. A row of more than LONG edges takes its whole
// block of eight warps: on BA(169343, 7), 123 hub rows (2.4% of the edges,
// up to ~3k each) held one warp each for the whole of the kernel (on an
// H100 at F = 128, 0.73 ms with them and 0.29 without). Widths under 32 put the lanes over
// the edges instead (one pass a feature) and reduce across the warp in a
// fixed tree.
//
// A warp sums one tile of 32 * VEC * CH columns. The grid is 2-D: block
// (x, y) takes rows x * ROWS + [0, ROWS) over column tile y alone, so a
// row wider than a tile is as many warps as it has tiles. That is for the
// PPR series (augment/diffusion.py), a product at F = n. At n = 19,717
// (odd, so VEC 1: 155 tiles of 128 columns) T has rows of 200-255 edges,
// just under LONG; on a 1-D grid each held one warp for 155 walks of its
// edges, tens of thousands of dependent load rounds, and set the kernel's
// length: 11-13.5 ms a product on an H100, against a floor of 0.93 ms (S
// read once and written once at 3.35 TB/s); 2.05 ms on this grid.
// blockIdx.x runs fastest, so all of tile 0's blocks are dispatched
// before tile 1's: one tile's slice of x (n * 512 bytes, ~10 MB there)
// stays in L2 while its gathers run, x is read from device memory about
// once, and the gathers, E * F values, come from L2. Every width up to
// one tile (the encoders' 128, 500 and 512) launches one tile: the grid
// and blocks of a 1-D launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;  // warps, and rows, a block
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// slot k of [.., end): its (col, w), or (n, 0) past the end or where col
// is n
template <typename T>
__device__ __forceinline__ void load_pair(
    const int* __restrict__ col, const T* __restrict__ w, int k, int end,
    int n, int& c, T& wk) {
  c = n;
  wk = T(0);
  if (k < end) {
    c = col[k];
    wk = c < n ? w[k] : T(0);
  }
}

// lanes over the features: lane l holds features t0 + (c * 32 + l) * VEC
// + [0, VEC) for c in [0, CH). Adds the edges [beg, end) to acc, in
// order: the next 32 (col, w) pairs are loaded while the current 32 are
// summed, U edges' rows loaded before their sums.
template <typename T, int VEC, int CH, int U>
__device__ __forceinline__ void add_edges(
    T (&acc)[CH][VEC], const T* __restrict__ x, const int* __restrict__ col,
    const T* __restrict__ w, int beg, int end, int n, int f, int t0,
    int lane) {
  int off[CH];
  bool live[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    off[c] = t0 + (c * 32 + lane) * VEC;
    live[c] = off[c] < f;  // f % VEC == 0
  }
  int cl;
  T wl;
  load_pair(col, w, beg + lane, end, n, cl, wl);
  for (int k0 = beg; k0 < end; k0 += 32) {
    int cn;
    T wn;
    load_pair(col, w, k0 + 32 + lane, end, n, cn, wn);
    const int cnt = min(32, end - k0);
    // lanes past the end hold (n, 0): the last group is masked
    for (int j = 0; j < cnt; j += U) {
      int cu[U];
      T wu[U];
      Pack<T, VEC> val[U][CH];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cu[u] = __shfl_sync(FULL, cl, j + u);
        wu[u] = __shfl_sync(FULL, wl, j + u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (live[c] && cu[u] < n) {
            val[u][c] = *reinterpret_cast<const Pack<T, VEC>*>(
                x + static_cast<size_t>(cu[u]) * f + off[c]);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) val[u][c].v[v] = T(0);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[c][v] = fma(wu[u], val[u][c].v[v], acc[c][v]);
    }
    cl = cn;
    wl = wn;
  }
}

// One block, ROWS warps, for rows blockIdx.x * ROWS + [0, ROWS) over the
// TILE = 32 * VEC * CH columns from blockIdx.y * TILE. A row of at most
// LONG edges is its own warp's. A longer one (BA's hubs reach ~3k
// in-edges, and one warp's loads in flight set how fast it walks them) is
// then the whole block's: warp r sums the r-th of ROWS contiguous slices
// of its edges into shared memory, and the slices' sums are added in the
// order r = 0, 1, ....
constexpr int LONG = 32 * ROWS;

template <typename T, int VEC, int CH, int U>
__global__ void __launch_bounds__(ROWS * 32)
spmm_rows_kernel(const T* __restrict__ x, const int* __restrict__ rowptr,
                 const int* __restrict__ col, const T* __restrict__ w,
                 T* __restrict__ out, int n, int f) {
  constexpr int TILE = 32 * VEC * CH;
  __shared__ T part[ROWS][TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + warp;
  const int t0 = blockIdx.y * TILE;
  if (row < n) {  // warp-uniform
    const int beg = rowptr[row], end = rowptr[row + 1];
    if (end - beg <= LONG) {
      T acc[CH][VEC] = {};
      add_edges<T, VEC, CH, U>(acc, x, col, w, beg, end, n, f, t0, lane);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int off = t0 + (c * 32 + lane) * VEC;
        if (off < f) {
          Pack<T, VEC> o;
#pragma unroll
          for (int v = 0; v < VEC; ++v) o.v[v] = acc[c][v];
          *reinterpret_cast<Pack<T, VEC>*>(
              out + static_cast<size_t>(row) * f + off) = o;
        }
      }
    }
  }
  for (int r = 0; r < ROWS && row0 + r < n; ++r) {  // block-uniform
    const int beg = rowptr[row0 + r], end = rowptr[row0 + r + 1];
    if (end - beg <= LONG) continue;
    const int len = end - beg;
    const int lo = beg + static_cast<int>(
        static_cast<long long>(len) * warp / ROWS);
    const int hi = beg + static_cast<int>(
        static_cast<long long>(len) * (warp + 1) / ROWS);
    T acc[CH][VEC] = {};
    add_edges<T, VEC, CH, U>(acc, x, col, w, lo, hi, n, f, t0, lane);
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        part[warp][(c * 32 + lane) * VEC + v] = acc[c][v];
    __syncthreads();
    for (int i = threadIdx.x; i < TILE && t0 + i < f; i += ROWS * 32) {
      T sum = part[0][i];
#pragma unroll
      for (int q = 1; q < ROWS; ++q) sum += part[q][i];
      out[static_cast<size_t>(row0 + r) * f + t0 + i] = sum;
    }
    __syncthreads();
  }
}

// lanes over the edges, for f < 32: one pass over the row a feature, each
// lane summing every 32nd edge in order, then a fixed shuffle tree
template <typename T>
__global__ void __launch_bounds__(ROWS * 32)
spmm_narrow_kernel(const T* __restrict__ x, const int* __restrict__ rowptr,
                   const int* __restrict__ col, const T* __restrict__ w,
                   T* __restrict__ out, int n, int f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform
  const int beg = rowptr[row], end = rowptr[row + 1];
  for (int j = 0; j < f; ++j) {
    T acc = T(0);
    for (int k = beg + lane; k < end; k += 32) {
      const int c = col[k];
      if (c < n) acc = fma(w[k], x[static_cast<size_t>(c) * f + j], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(FULL, acc, o);
    if (lane == 0) out[static_cast<size_t>(row) * f + j] = acc;
  }
}

// CH, the chunks of 32 x VEC columns in a warp's tile, for width f: U * CH
// = 8 loads of VEC values in flight a lane
int chunks(int f, int vec) {
  const int c = (f + 32 * vec - 1) / (32 * vec);
  return c <= 1 ? 1 : c <= 2 ? 2 : 4;
}

// VEC of the launch for x and out at width f: 16 bytes over sizeof(T)
// where rows and pointers allow, 1 where not, 0 for the narrow kernel
template <typename T>
int vec_of(const void* x, const void* out, int f) {
  constexpr int VEC = 16 / sizeof(T);
  if (f < 32) return 0;
  const bool aligned = f % VEC == 0
      && reinterpret_cast<uintptr_t>(x) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return aligned ? VEC : 1;
}

// the column tiles of the launch, its gridDim.y (1 for the narrow kernel)
template <typename T>
int column_tiles(const void* x, const void* out, int f) {
  const int vec = vec_of<T>(x, out, f);
  if (vec == 0) return 1;
  const int tile = 32 * vec * chunks(f, vec);
  return (f + tile - 1) / tile;
}

template <typename T, int VEC>
void launch_rows(const T* x, const int* rowptr, const int* col, const T* w,
                 T* out, int n, int f, cudaStream_t s) {
  const dim3 grid((n + ROWS - 1) / ROWS, column_tiles<T>(x, out, f));
  const dim3 block(ROWS * 32);
  switch (chunks(f, VEC)) {
    case 1:
      spmm_rows_kernel<T, VEC, 1, 8><<<grid, block, 0, s>>>(x, rowptr, col,
                                                            w, out, n, f);
      break;
    case 2:
      spmm_rows_kernel<T, VEC, 2, 4><<<grid, block, 0, s>>>(x, rowptr, col,
                                                            w, out, n, f);
      break;
    default:
      spmm_rows_kernel<T, VEC, 4, 2><<<grid, block, 0, s>>>(x, rowptr, col,
                                                            w, out, n, f);
  }
}

template <typename T>
int spmm_csr(const void* xp, const void* rowptrp, const void* colp,
             const void* wp, void* outp, int n, int f, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const T* x = static_cast<const T*>(xp);
  const int* rowptr = static_cast<const int*>(rowptrp);
  const int* col = static_cast<const int*>(colp);
  const T* w = static_cast<const T*>(wp);
  T* out = static_cast<T*>(outp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int VEC = 16 / sizeof(T);
  switch (vec_of<T>(xp, outp, f)) {
    case 0:
      spmm_narrow_kernel<T><<<(n + ROWS - 1) / ROWS, ROWS * 32, 0, s>>>(
          x, rowptr, col, w, out, n, f);
      break;
    case VEC:
      launch_rows<T, VEC>(x, rowptr, col, w, out, n, f, s);
      break;
    default:
      launch_rows<T, 1>(x, rowptr, col, w, out, n, f, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [n, f], rowptr int32 [n + 2], col int32 [E], w [E], out [n, f]; all
// contiguous, on the stream's device
int spmm_csr_f32(const void* x, const void* rowptr, const void* col,
                 const void* w, void* out, int n, int f, void* stream) {
  return spmm_csr<float>(x, rowptr, col, w, out, n, f, stream);
}

int spmm_csr_f64(const void* x, const void* rowptr, const void* col,
                 const void* w, void* out, int n, int f, void* stream) {
  return spmm_csr<double>(x, rowptr, col, w, out, n, f, stream);
}

// the column tiles (gridDim.y) of the launch above for x and out at width
// f: more than 1 where a row is wider than a warp's tile
int spmm_csr_tiles_f32(const void* x, const void* out, int f) {
  return column_tiles<float>(x, out, f);
}

int spmm_csr_tiles_f64(const void* x, const void* out, int f) {
  return column_tiles<double>(x, out, f);
}

}  // extern "C"
