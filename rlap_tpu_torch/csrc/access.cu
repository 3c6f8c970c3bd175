// Gather and scatter-min access probes on Hopper: eight int32 kernels.
//
// They replace the eight Pallas TPU kernels of the access-probe tools:
//   take_kernel             <- C1 k_take   tools/probe_access.py:135  (call :139)
//   take_two_level_kernel   <- C2 k_tala   tools/probe_access.py:170  (call :180)
//   take_scalar_kernel      <- C3 k_scalar tools/probe_access.py:208  (call :215)
//   fill_kernel + scatter_min_kernel
//                           <- C4 k_smin   tools/probe_access.py:239  (call :251)
//   take2d_kernel           <- V1 k_v1     tools/probe_access2.py:85  (call :53)
//   take_axis0_kernel       <- V2 k_v2     tools/probe_access2.py:97  (call :102)
//   take_axis1_kernel       <- V3 k_v3     tools/probe_access2.py:136 (call :143)
//   take_axis0_axis1_kernel <- V4 k_v4     tools/probe_access2.py:175 (call :194)
//
// The probed pattern is the vertex-table access of the rLap round: a
// lookup in an n-entry table by ~2 |edges| indices, and a scatter-min into
// an n-entry table. At the probes' default shape (n = 100000, 1.6 M
// indices) a lookup moves 4 bytes of index, 4 of output and a 400 KB
// table: 13.2 MB, 3.9 us at 3.35 TB/s. All eight are bound by bytes; what
// they probe is how far the random table access keeps them from that.
//
// The TPU kernels hold the whole table in VMEM and walk index tiles with
// a sequential grid. This card has neither: a block has at most 227 KB of
// shared memory, less than the table, and blocks run in no order. So the
// table stays in device memory and is served by the 50 MB L2 (take,
// take2d, take_axis0, scatter_min), or is cut into chunks that fit shared
// memory (take_two_level), and only the small per-row tables of
// take_axis1 and take_axis0_axis1 are staged whole. Ragged sizes are
// masked in the kernels; the TPU calls need E to be a multiple of 8192.
//
// Indices must lie in [0, table size); they are not checked on the card.
// A [R, 128] table is row-major, so row idx / 128, lane idx % 128 is the
// flat entry idx; the 2-D kernels take [M, 128] index tiles as quads of
// four consecutive indices (one 128-bit load and store per thread).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 128;               // table row width, as on the TPU
constexpr int QUADS_PER_ROW = LANES / 4;
constexpr int MAX_BLOCKS = 132 * 16;     // grid-stride cap: 16 blocks an SM
constexpr int STAGE_THREADS = 1024;
// take_two_level: the most table entries one block stages (224 KB of the
// 227 KB a block may use).
constexpr int MAX_CHUNK = 57344;

inline int grid_for(int64_t work) {
  const int64_t blocks = (work + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS
                                                                : blocks));
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// C1. out[i] = table[idx[i]]: one thread per index, coalesced index loads
// and stores, the table through the read-only path. The table is read
// from L2 after its first touch: "table in L2" for "table in VMEM".
__global__ void __launch_bounds__(THREADS)
take_kernel(const int* __restrict__ table, const int* __restrict__ idx,
            int* __restrict__ out, int64_t e) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride)
    out[i] = __ldg(table + idx[i]);
}

// C2. The same lookup in two levels. blockIdx.y names a chunk of the table
// that fits shared memory; the block stages it with coalesced loads, then
// walks its range of indices (blockIdx.x) and serves those that fall in
// the chunk. An index falls in exactly one chunk, so every output is
// written exactly once: no atomics, no zero-fill. The chunk load is paid
// per block: at the default shape (2 chunks of 50048 entries, 66 ranges of
// 24243 indices on 132 SMs) a block stages 2.06 table entries per index
// it reads, and every index is read once per chunk.
__global__ void __launch_bounds__(STAGE_THREADS)
take_two_level_kernel(const int* __restrict__ table,
                      const int* __restrict__ idx, int* __restrict__ out,
                      int nt, int64_t e, int chunk, int64_t range) {
  extern __shared__ int stage[];
  const int base = blockIdx.y * chunk;
  const int len = nt - base < chunk ? nt - base : chunk;
  for (int k = threadIdx.x; k < len; k += blockDim.x)
    stage[k] = table[base + k];
  __syncthreads();
  const int64_t lo = (int64_t)blockIdx.x * range;
  const int64_t hi = lo + range < e ? lo + range : e;
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const unsigned off = (unsigned)(idx[i] - base);
    if (off < (unsigned)len) out[i] = stage[off];
  }
}

// C3. One thread walks the indices one after another: the latency of a
// dependent index load and table load per element, with nothing to hide
// it. It is meant to be slow.
__global__ void take_scalar_kernel(const int* __restrict__ table,
                                   const int* __restrict__ idx,
                                   int* __restrict__ out, int e) {
  for (int i = 0; i < e; ++i) out[i] = table[idx[i]];
}

// C4. out = full(nt, 2^30), then out[idx[i]] = min(out[idx[i]], val[i]) by
// atomicMin in L2. Min does not depend on the order, so the result is
// deterministic.
__global__ void __launch_bounds__(THREADS)
fill_kernel(int* __restrict__ out, int nt, int value) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nt; i += stride)
    out[i] = value;
}

__global__ void __launch_bounds__(THREADS)
scatter_min_kernel(const int* __restrict__ idx, const int* __restrict__ val,
                   int* __restrict__ out, int64_t e) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride)
    atomicMin(out + idx[i], val[i]);
}

// V1. out[i, j] = tab[idx[i, j] / 128, idx[i, j] % 128] on [M, 128] index
// tiles: four indices a thread, 128-bit index loads and output stores.
__device__ __forceinline__ int lookup(const int* __restrict__ tab, int j) {
  return __ldg(tab + (j >> 7) * LANES + (j & (LANES - 1)));
}

__global__ void __launch_bounds__(THREADS)
take2d_kernel(const int* __restrict__ tab, const int4* __restrict__ idx,
              int4* __restrict__ out, int64_t quads) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += stride) {
    const int4 j = idx[q];
    out[q] = make_int4(lookup(tab, j.x), lookup(tab, j.y), lookup(tab, j.z),
                       lookup(tab, j.w));
  }
}

// V2. out[i, j] = tab[idx[i, j] / 128, j]: lane j always reads column j. A
// plain gather against L2 (the table is not staged); the four entries of
// a quad lie in four table rows.
__global__ void __launch_bounds__(THREADS)
take_axis0_kernel(const int* __restrict__ tab, const int4* __restrict__ idx,
                  int4* __restrict__ out, int64_t quads) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += stride) {
    const int4 j = idx[q];
    const int* col = tab + 4 * (int)(q % QUADS_PER_ROW);
    out[q] = make_int4(__ldg(col + (j.x >> 7) * LANES),
                       __ldg(col + (j.y >> 7) * LANES + 1),
                       __ldg(col + (j.z >> 7) * LANES + 2),
                       __ldg(col + (j.w >> 7) * LANES + 3));
  }
}

// V3. out[i, j] = tab[0, idx[i, j] % 128]: the 128-entry row is staged
// once per block in shared memory, then each thread selects four lanes.
__global__ void __launch_bounds__(THREADS)
take_axis1_kernel(const int* __restrict__ tab, const int4* __restrict__ idx,
                  int4* __restrict__ out, int64_t quads) {
  __shared__ int row[LANES];
  if (threadIdx.x < LANES) row[threadIdx.x] = tab[threadIdx.x];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += stride) {
    const int4 j = idx[q];
    out[q] = make_int4(row[j.x & (LANES - 1)], row[j.y & (LANES - 1)],
                       row[j.z & (LANES - 1)], row[j.w & (LANES - 1)]);
  }
}

// V4. V2 then V3 on its result: byrow[i, k] = tab[idx[i, k] / 128, k], then
// out[i, j] = byrow[i, idx[i, j] % 128]. One warp per index row: it stages
// its 128 entries of byrow in shared memory (four a lane), syncs the warp,
// and selects.
__global__ void __launch_bounds__(THREADS)
take_axis0_axis1_kernel(const int* __restrict__ tab,
                        const int4* __restrict__ idx, int4* __restrict__ out,
                        int m) {
  __shared__ int byrow[WARPS][LANES];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* mine = byrow[warp];
  const int* col = tab + 4 * lane;
  for (int i = blockIdx.x * WARPS + warp; i < m; i += gridDim.x * WARPS) {
    const int64_t q = (int64_t)i * QUADS_PER_ROW + lane;
    const int4 j = idx[q];
    mine[4 * lane] = __ldg(col + (j.x >> 7) * LANES);
    mine[4 * lane + 1] = __ldg(col + (j.y >> 7) * LANES + 1);
    mine[4 * lane + 2] = __ldg(col + (j.z >> 7) * LANES + 2);
    mine[4 * lane + 3] = __ldg(col + (j.w >> 7) * LANES + 3);
    __syncwarp();
    out[q] = make_int4(mine[j.x & (LANES - 1)], mine[j.y & (LANES - 1)],
                       mine[j.z & (LANES - 1)], mine[j.w & (LANES - 1)]);
    __syncwarp();  // before the next row overwrites the stage
  }
}

}  // namespace

// Plain C interface for ctypes. Each launches on `stream`, does not
// synchronise, and returns the CUDA error of its set-up or launch (0 on
// success).
extern "C" {

int access_take(const void* table, const void* idx, void* out, int e,
                void* stream) {
  if (e <= 0) return 0;
  take_kernel<<<grid_for(e), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(idx),
      static_cast<int*>(out), e);
  return last_error();
}

int access_take_two_level(const void* table, const void* idx, void* out,
                          int nt, int e, void* stream) {
  if (e <= 0 || nt <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (nt + MAX_CHUNK - 1) / MAX_CHUNK;
  const int chunk = (((nt + chunks - 1) / chunks) + 3) / 4 * 4;  // <= MAX_CHUNK
  // one wave: a block of this size has an SM to itself
  int64_t ranges = sms / chunks < 1 ? 1 : sms / chunks;
  const int64_t most = ((int64_t)e + STAGE_THREADS - 1) / STAGE_THREADS;
  if (ranges > most) ranges = most;
  const int64_t range = ((int64_t)e + ranges - 1) / ranges;
  const size_t bytes = sizeof(int) * (size_t)chunk;
  err = cudaFuncSetAttribute(take_two_level_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  take_two_level_kernel<<<dim3((unsigned)ranges, (unsigned)chunks),
                          STAGE_THREADS, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(idx),
      static_cast<int*>(out), nt, e, chunk, range);
  return last_error();
}

int access_take_scalar(const void* table, const void* idx, void* out, int e,
                       void* stream) {
  if (e <= 0) return 0;
  take_scalar_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(idx),
      static_cast<int*>(out), e);
  return last_error();
}

int access_scatter_min(const void* idx, const void* val, void* out, int nt,
                       int e, int fill, void* stream) {
  if (nt <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_kernel<<<grid_for(nt), THREADS, 0, s>>>(static_cast<int*>(out), nt,
                                               fill);
  int err = last_error();
  if (err != 0 || e <= 0) return err;
  scatter_min_kernel<<<grid_for(e), THREADS, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const int*>(val),
      static_cast<int*>(out), e);
  return last_error();
}

int access_take2d(const void* tab, const void* idx, void* out, int m,
                  void* stream) {
  if (m <= 0) return 0;
  const int64_t quads = (int64_t)m * QUADS_PER_ROW;
  take2d_kernel<<<grid_for(quads), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int4*>(idx),
      static_cast<int4*>(out), quads);
  return last_error();
}

int access_take_axis0(const void* tab, const void* idx, void* out, int m,
                      void* stream) {
  if (m <= 0) return 0;
  const int64_t quads = (int64_t)m * QUADS_PER_ROW;
  take_axis0_kernel<<<grid_for(quads), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int4*>(idx),
      static_cast<int4*>(out), quads);
  return last_error();
}

int access_take_axis1(const void* tab, const void* idx, void* out, int m,
                      void* stream) {
  if (m <= 0) return 0;
  const int64_t quads = (int64_t)m * QUADS_PER_ROW;
  take_axis1_kernel<<<grid_for(quads), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int4*>(idx),
      static_cast<int4*>(out), quads);
  return last_error();
}

int access_take_axis0_axis1(const void* tab, const void* idx, void* out,
                            int m, void* stream) {
  if (m <= 0) return 0;
  const int blocks = (m + WARPS - 1) / WARPS;
  take_axis0_axis1_kernel<<<blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks,
                            THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int4*>(idx),
      static_cast<int4*>(out), m);
  return last_error();
}

}  // extern "C"
