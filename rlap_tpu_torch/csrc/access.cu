// Gather and scatter-min access probes on Hopper: int32 kernels.
//
// They replace the eight Pallas TPU kernels of the access-probe tools:
//   take_kernel             <- C1 k_take   tools/probe_access.py:135  (call :139)
//   take_two_level_cluster_kernel
//                           <- C2 k_tala   tools/probe_access.py:170  (call :180)
//   take_scalar_cluster_kernel
//                           <- C3 k_scalar tools/probe_access.py:208  (call :215)
//   fill_trigger_kernel + scatter_min_merged_kernel
//                           <- C4 k_smin   tools/probe_access.py:239  (call :251)
//   take2d_kernel           <- V1 k_v1     tools/probe_access2.py:85  (call :53)
//   take_axis0_slab_kernel  <- V2 k_v2     tools/probe_access2.py:97  (call :102)
//   take_axis1_kernel       <- V3 k_v3     tools/probe_access2.py:136 (call :143)
//   take_axis0_axis1_kernel <- V4 k_v4     tools/probe_access2.py:175 (call :194)
//
// The probed pattern is the vertex-table access of the rLap round: a
// lookup in an n-entry table by ~2 |edges| indices, and a scatter-min into
// an n-entry table. At the probes' default shape (n = 100000, 1.6 M
// indices) a lookup moves 4 bytes of index, 4 of output and a 400 KB
// table: 13.2 MB, 3.9 us at 3.35 TB/s. All are bound by bytes, except the
// one-thread walk of C3, which is bound by latency; what they probe is how
// far the random table access keeps them from that. A random 4-byte read
// that L2 serves costs a 32-byte sector: C1's take_kernel moves 32 bytes
// of L2 traffic for each 4-byte entry it reads.
//
// The TPU kernels hold the whole table in VMEM and walk index tiles with
// a sequential grid. On this card a block has at most 227 KB of shared
// memory, less than the 400 KB table, and blocks run in no order. A
// thread-block cluster of k blocks on neighbouring SMs shares its shared
// memory (distributed shared memory, up to 8 x 227 KB in a portable
// cluster), which holds such a table on-chip. C3 stages it there for its
// one-thread walk; C2 launches persistent clusters, each of which stages
// the whole table in equal slices across its blocks and serves its share
// of the indices from it (the cluster-resident table below). C1 reads the
// table from the 50 MB L2: a design that held it in a cluster and routed
// each index to the block holding its entry took twice the time on this
// card. V4 reads it from L2 too: served from the cluster-resident table,
// it was slower on random indices and on the rLap stream. V2 needs no
// cluster: lane j reads only column j, so a block that stages a group of
// columns serves all of their reads. V1 reads one 512-byte table row for each row of 128
// indices, from L2, and selects its lanes inside the warp; V3's one
// 128-entry row is staged whole in each block. Ragged sizes are masked in
// the kernels; the TPU calls need E to be a multiple of 8192.
//
// Indices must lie in [0, table size); they are not checked on the card.
// A [R, 128] table is row-major, so row idx / 128, lane idx % 128 is the
// flat entry idx; the 2-D kernels take [M, 128] index tiles as quads of
// four consecutive indices (one 128-bit load and store per thread).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <utility>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 128;               // table row width, as on the TPU
constexpr int QUADS_PER_ROW = LANES / 4;
constexpr int MAX_BLOCKS = 132 * 16;     // grid-stride cap: 16 blocks an SM

inline int grid_for(int64_t work) {
  const int64_t blocks = (work + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > MAX_BLOCKS ? MAX_BLOCKS
                                                                : blocks));
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// C1 (take). out[i] = table[idx[i]]: one thread per index, coalesced
// index loads and stores, the table through the read-only path. The table
// is read from L2 after its first touch: "table in L2" for "table in
// VMEM".
__global__ void __launch_bounds__(THREADS)
take_kernel(const int* __restrict__ table, const int* __restrict__ idx,
            int* __restrict__ out, int64_t e) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < e;
       i += stride)
    out[i] = __ldg(table + idx[i]);
}

// C3. The TPU probe walks a VMEM table with one scalar loop: the floor of
// addressing one element at a time on-chip. Here the table lives in the
// shared memory of a cluster of k blocks (k <= 8, from the wrapper's plan):
// block 0 holds entries [0, head) and the index tile, block r >= 1 holds
// [head + (r - 1) slice, head + r slice). Layout of each block's dynamic
// shared memory: the mbarrier (16 bytes), its table slice, then in block 0
// the index tile. Each block stages its slice with one bulk asynchronous
// copy (TMA, completion on its mbarrier) and the last < 4 entries, which a
// bulk copy cannot take (16-byte multiples), with plain loads. After a
// cluster barrier, thread 0 of block 0 walks the indices alone: it maps
// each entry's owner with mapa and reads it by ld.shared::cluster, block
// 0's own entries too. (ptxas makes every such read a generic load
// through the shared window. Where only the other blocks' entries take
// that path and block 0's take ld.shared, it fetches the window's base
// per element, behind a predicate, and the walk was slower on the card.)
// Iterations are independent, as on the TPU, so the walk issues 32 loads
// before their 32 stores; with 8 it was slower. Each result goes back
// over its own index in the tile, which the walk has read, and one bulk
// copy stores the tile to device memory at the end: block 0 has no room
// for a second tile. A second cluster barrier keeps every block's shared
// memory alive until the walk is done. The walk is bound by the latency
// and issue rate of distributed shared memory reads, not by bytes;
// `cycles` (optional) receives the staging and walk spans in clock64
// cycles and the number of reads of another block's slice.
constexpr int SCALAR_THREADS = 32;
constexpr int SCALAR_UNROLL = 32;
constexpr int BARRIER_BYTES = 16;  // the mbarrier's slot at a stage's head

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one thread: set up the block's mbarrier to complete when `bytes` have
// arrived by bulk copies; the cluster may see it from here on
__device__ __forceinline__ void mbarrier_expect(uint64_t* bar,
                                                uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}

// the word at shared address `addr` of block `rank` of the cluster
__device__ __forceinline__ int dsmem_load(uint32_t addr, unsigned rank) {
  int v;
  asm volatile(
      "{\n"
      ".reg .b32 a;\n"
      "mapa.shared::cluster.u32 a, %1, %2;\n"
      "ld.shared::cluster.u32 %0, [a];\n"
      "}\n"
      : "=r"(v)
      : "r"(addr), "r"(rank));
  return v;
}

// entry j of the table, from the shared memory of the block that holds it
// (C3's layout: block 0 holds [0, head), then slices of `slice`)
__device__ __forceinline__ int cluster_entry(uint32_t tab, unsigned j,
                                             unsigned head, unsigned slice,
                                             unsigned long long magic,
                                             unsigned& remote) {
  const unsigned x = j - head;  // wraps when j < head; then unused
  const unsigned q = static_cast<unsigned>((x * magic) >> 40);  // x / slice
  const bool far = j >= head;
  remote += far;
  return dsmem_load(tab + 4 * (far ? x - q * slice : j), far ? q + 1 : 0u);
}

__global__ void __launch_bounds__(SCALAR_THREADS)
take_scalar_cluster_kernel(const int* __restrict__ table,
                           const int* __restrict__ idx, int* __restrict__ out,
                           long long* __restrict__ cycles, int n, int e,
                           int head, int slice, unsigned long long magic) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long t0 = clock64();
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* tab = reinterpret_cast<int*>(smem + BARRIER_BYTES);
  const int start = rank == 0 ? 0 : head + (int)(rank - 1) * slice;
  const int most = rank == 0 ? head : slice;
  const int len = n - start < 0 ? 0 : (n - start > most ? most : n - start);
  int* ix = tab + ((head + 3) & ~3);  // block 0 only
  const int len4 = len & ~3, e4 = e & ~3;
  if (threadIdx.x == 0) {
    mbarrier_expect(bar, 4 * (len4 + (rank == 0 ? e4 : 0)));
    if (len4 > 0) bulk_copy(tab, table + start, 4 * len4, bar);
    if (rank == 0 && e4 > 0) bulk_copy(ix, idx, 4 * e4, bar);
  }
  // the ragged ends, fewer than 4 entries each
  if ((int)threadIdx.x < len - len4)
    tab[len4 + threadIdx.x] = table[start + len4 + threadIdx.x];
  if (rank == 0 && (int)threadIdx.x < e - e4)
    ix[e4 + threadIdx.x] = idx[e4 + threadIdx.x];
  if (threadIdx.x == 0) mbarrier_wait(bar, 0);
  cluster.sync();  // every slice staged and visible to the whole cluster

  if (rank == 0 && threadIdx.x == 0) {
    const long long t1 = clock64();
    const uint32_t base = smem_u32(tab);
    unsigned remote = 0;
    int i = 0;
    for (; i + SCALAR_UNROLL <= e; i += SCALAR_UNROLL) {
      int j[SCALAR_UNROLL], v[SCALAR_UNROLL];
#pragma unroll
      for (int u = 0; u < SCALAR_UNROLL; u += 4)
        *reinterpret_cast<int4*>(j + u) =
            *reinterpret_cast<const int4*>(ix + i + u);
#pragma unroll
      for (int u = 0; u < SCALAR_UNROLL; ++u)
        v[u] = cluster_entry(base, j[u], head, slice, magic, remote);
#pragma unroll
      for (int u = 0; u < SCALAR_UNROLL; ++u) ix[i + u] = v[u];
    }
    for (; i < e; ++i)
      ix[i] = cluster_entry(base, ix[i], head, slice, magic, remote);
    // the results, in the index tile, to device memory
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (e4 > 0)
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          ::"l"(out), "r"(smem_u32(ix)), "r"(4 * e4)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    for (int t = e4; t < e; ++t) out[t] = ix[t];
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    const long long t2 = clock64();
    if (cycles != nullptr) {
      cycles[0] = t1 - t0;
      cycles[1] = t2 - t1;
      cycles[2] = remote;
    }
  }
  cluster.sync();  // no block leaves while block 0 may still read it
}

// C4. out = full(nt, 2^30), then out[idx[i]] = min(out[idx[i]], val[i])
// by atomics in L2; min does not depend on the order, so the result is
// deterministic. On the rLap
// endpoint stream, which is sorted by sender, a hub is a long run of one
// index: one atomicMin a lane sends the whole warp to one L2 address, one
// after another. Here each thread takes 4 consecutive updates (one 16-byte
// load of indices, one of values) and merges equal neighbours in
// registers, so that the last of a run carries its minimum. A run longer
// than a quad ends in slot 3 of every lane it covers, so slot 3 is merged
// across the warp: where some lane's slot-3 index repeats the previous
// lane's, __match_any_sync groups the lanes that hold the same index, the
// group's minimum comes from __reduce_min_sync, and its lowest lane alone
// issues the red.global.min. Other live slots issue theirs directly.
// (Random indices almost never repeat within a warp, and a match is not
// cheap: a match for every slot of every quad made the kernel slower on
// random indices than one atomic an update.) Warps
// take 32 consecutive quads, with a warp-uniform loop, so that the whole
// warp takes part in every match. The fill is its own launch, but the
// reduction is launched with programmatic dependent launch: its blocks
// load and merge while the fill runs, and wait for the fill
// (griddepcontrol.wait) only before their first red. The < 4 updates
// before the first 16-byte boundary of idx (the head; idx and val share
// their alignment) and after the last whole quad (the tail) take one
// atomic each.
__global__ void __launch_bounds__(THREADS)
fill_trigger_kernel(int* __restrict__ out, int nt, int value) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int quads = nt / 4;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int q = first; q < quads; q += stride)
    out4[q] = make_int4(value, value, value, value);
  if (first < nt - 4 * quads) out[4 * quads + first] = value;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void red_min(int* addr, int v) {
  asm volatile("red.relaxed.gpu.global.min.s32 [%0], %1;\n" ::"l"(addr),
               "r"(v)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
scatter_min_merged_kernel(const int* __restrict__ idx,
                          const int* __restrict__ val, int* __restrict__ out,
                          int head, int64_t quads, int64_t e) {
  constexpr unsigned FULL = 0xffffffffu;
  const unsigned lane = threadIdx.x % 32;
  const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
  const int4* val4 = reinterpret_cast<const int4*>(val + head);
  const int64_t warps = (int64_t)gridDim.x * WARPS;
  bool waited = false;
  for (int64_t base = ((int64_t)blockIdx.x * WARPS + threadIdx.x / 32) * 32;
       base < quads; base += warps * 32) {
    const int64_t q = base + lane;
    int k[4] = {0, 0, 0, 0}, v[4] = {0, 0, 0, 0};
    bool live[4] = {false, false, false, false};
    if (q < quads) {
      const int4 a = __ldg(idx4 + q), b = __ldg(val4 + q);
      k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
      v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        live[u] = k[u] != k[u + 1];
        if (!live[u]) v[u + 1] = min(v[u + 1], v[u]);
      }
      live[3] = true;
    }
    if (!waited) {  // the fill's stores are complete and visible after this
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      waited = true;
    }
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (live[u]) red_min(out + k[u], v[u]);
    bool lead = live[3];
    int m = v[3];
    const int prev = __shfl_up_sync(FULL, k[3], 1);
    if (__any_sync(FULL, live[3] && lane > 0 && prev == k[3])) {
      // a dead slot gets a key no index has, so it groups with no lane
      const unsigned key = live[3] ? (unsigned)k[3] : (0x80000000u | lane);
      const unsigned group = __match_any_sync(FULL, key);
      m = __reduce_min_sync(group, v[3]);
      lead = live[3] && (group & ((1u << lane) - 1)) == 0;
    }
    if (lead) red_min(out + k[3], m);
  }
  if (!waited) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int64_t tail = e - head - 4 * quads;
    const int t = threadIdx.x;
    const int64_t i = t < 4 ? (t < head ? t : -1)
                            : (t - 4 < tail ? head + 4 * quads + (t - 4) : -1);
    if (i >= 0) red_min(out + idx[i], val[i]);
  }
}

// V1. out[i, j] = tab[idx[i, 0] / 128, idx[i, j] % 128]: k_v1 gathers the
// table row of every index, keeps sel[:, 0, :], the row of each index
// row's first index, and selects lanes from it. So each row of 128
// indices reads one 512-byte table row. One warp a row: each lane loads
// its quad of indices (16 bytes), lane 0's first index names the row and
// reaches the warp by a shuffle, each lane loads its quad of the table row
// (one coalesced 512-byte request, from L2 after its first touch; 4-byte
// loads where the table is not 16-byte aligned) and writes it to the
// warp's 512-byte slot of shared memory; after __syncwarp each lane reads
// its four lanes there and stores its quad of outputs (16 bytes). The
// grid's warps stride over the rows, the next row's indices loaded before
// the current row's selects and stores. No cluster and no stage of the
// whole table: the table's bytes per index are 4 / 128 of an index's.
// (Measured on the card at M = 12500: a select by 16 shuffles of the row's
// quads, with no shared memory, and 2 or 4 rows a warp in flight were 2-15%
// slower.)
//
// What bounds it: the index rows in and the outputs out (8 bytes an
// index) from device memory; the table rows come from L2, 512 bytes for
// 128 indices. `cycles` (optional, 3 int64) receives warp 0 of block 0's
// load span (from the top of each row to its table row in shared memory)
// and select span (to its stores issued), summed over its rows, in
// clock64 cycles, and the blocks launched.
constexpr int V1_THREADS = 256;
constexpr int V1_WARPS = V1_THREADS / 32;

__global__ void __launch_bounds__(V1_THREADS)
take2d_kernel(const int* __restrict__ tab, const int4* __restrict__ idx,
              int4* __restrict__ out, long long* __restrict__ cycles, int m) {
  __shared__ __align__(16) int4 stage[V1_WARPS][QUADS_PER_ROW];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vec = (reinterpret_cast<uintptr_t>(tab) & 15) == 0;
  const bool timed = cycles != nullptr && blockIdx.x == 0 && warp == 0;
  const int warps = gridDim.x * V1_WARPS;
  const int* s = reinterpret_cast<const int*>(stage[warp]);
  long long load = 0, select = 0;
  int i = blockIdx.x * V1_WARPS + warp;  // warp-uniform
  int4 j = i < m ? __ldg(idx + (int64_t)i * QUADS_PER_ROW + lane)
                 : make_int4(0, 0, 0, 0);
  for (; i < m; i += warps) {
    const long long t0 = timed ? clock64() : 0;
    const int r = __shfl_sync(0xffffffffu, j.x, 0) >> 7;
    const int* p = tab + (int64_t)r * LANES + 4 * lane;
    const int4 row =
        vec ? __ldg(reinterpret_cast<const int4*>(p))
            : make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    const int ni = i + warps;
    const int4 next = ni < m ? __ldg(idx + (int64_t)ni * QUADS_PER_ROW + lane)
                             : make_int4(0, 0, 0, 0);
    stage[warp][lane] = row;
    __syncwarp();
    const long long t1 = timed ? clock64() : 0;
    out[(int64_t)i * QUADS_PER_ROW + lane] =
        make_int4(s[j.x & (LANES - 1)], s[j.y & (LANES - 1)],
                  s[j.z & (LANES - 1)], s[j.w & (LANES - 1)]);
    __syncwarp();  // before the next row overwrites the slot
    j = next;
    if (timed) {
      load += t1 - t0;
      select += clock64() - t1;
    }
  }
  if (timed && lane == 0) {
    cycles[0] = load;
    cycles[1] = select;
    cycles[2] = gridDim.x;
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

// V4. V2 then V3 on its result: byrow[i, k] = tab[idx[i, k] / 128, k],
// then out[i, j] = byrow[i, idx[i, j] % 128]. One warp per index row: it
// reads its 128 entries of byrow from L2 (four a lane), stages them in
// shared memory, syncs the warp, and selects.
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


// ---------------------------------------------------------------------------
// The cluster-resident table (C2). A persistent grid of clusters of
// k blocks (k <= 8, from the wrapper's table_plan), as many as the card
// holds at once. Each block holds an equal slice of `slice` entries (a
// multiple of 4): entry j lies in block j / slice of every cluster, at
// offset j % slice, so that each cluster holds the whole table and serves
// its share of the indices from it. Layout of a block's dynamic shared
// memory: the mbarrier (16 bytes), then its slice. Each block stages its
// slice by
// one bulk asynchronous copy (rows of 128 entries make every slice
// whole 16-byte units), which completes on its mbarrier; while it is in
// flight, each thread loads its first indices. Then thread 0 waits on the
// mbarrier and the cluster synchronises, after which every slice is
// visible to the whole cluster. A read maps the owner with mapa and loads by
// ld.shared::cluster, the block's own entries too (C3 found that ptxas
// makes every such read a generic load through the shared window, and
// that a separate path for the own slice fetches the window's base per
// read). The owner is a multiply-shift, j / slice == (j * magic) >> 40 for
// j < 2^19. A last cluster barrier keeps every slice alive until the
// cluster's reads are done. `cycles` (optional) receives, from block 0 of
// cluster 0, the staging span (launch to the first cluster barrier) and
// the lookup span (to the last) in clock64 cycles, and the number of
// clusters launched.
//
// What bounds it: each cluster stages the whole table (clusters x 4 nt
// bytes from L2), and each index costs one random 4-byte read of
// distributed shared memory, whose rate this probe measures. The bytes
// bound (indices in, outputs out, the table once) is 3.9 us at the default
// shape.
constexpr int CLUSTER_THREADS = 512;
constexpr int TAKE_UNROLL = 2;  // C2: index quads a thread has in flight

// entry j of a table cut into equal slices, one a block of the cluster
__device__ __forceinline__ int slice_entry(uint32_t tab, unsigned j,
                                           unsigned slice,
                                           unsigned long long magic) {
  const unsigned q = static_cast<unsigned>((j * magic) >> 40);  // j / slice
  return dsmem_load(tab + 4 * (j - q * slice), q);
}

// thread 0 starts the bulk copy of this block's slice of an n-entry table
// (entries [rank slice, (rank + 1) slice)); every thread loads what the
// copy cannot take (the last < 4 entries, or all where the table is not
// 16-byte aligned). Returns the slice.
__device__ __forceinline__ int* stage_slice(unsigned char* smem,
                                            const int* __restrict__ table,
                                            int n, int slice, unsigned rank) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* tab = reinterpret_cast<int*>(smem + BARRIER_BYTES);
  const int start = static_cast<int>(rank) * slice;
  const int len = n - start < 0 ? 0 : (n - start < slice ? n - start : slice);
  const bool bulk = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  const int len4 = bulk ? (len & ~3) : 0;
  if (threadIdx.x == 0) {
    mbarrier_expect(bar, 4 * len4);
    if (len4 > 0) bulk_copy(tab, table + start, 4 * len4, bar);
  }
  for (int i = len4 + threadIdx.x; i < len; i += blockDim.x)
    tab[i] = __ldg(table + start + i);
  return tab;
}

// every slice of the cluster staged and visible to the whole cluster
__device__ __forceinline__ void stage_wait(unsigned char* smem,
                                           cg::cluster_group& cluster) {
  if (threadIdx.x == 0) mbarrier_wait(reinterpret_cast<uint64_t*>(smem), 0);
  cluster.sync();
}

__device__ __forceinline__ void record_spans(long long* cycles, long long t0,
                                             long long t1,
                                             cg::cluster_group& cluster) {
  if (cycles != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = clock64() - t1;
    cycles[2] = gridDim.x / cluster.num_blocks();
  }
}

// C2. out[i] = tab2d[idx[i] / 128, idx[i] % 128], the flat entry idx[i],
// from the cluster-resident table: the TPU probe's two levels, row then
// lane, become owner block then offset in its shared memory. The grid
// walks the index quads with a grid stride (16-byte loads of indices and
// stores of outputs; out lies at idx's offset from a 16-byte boundary),
// TAKE_UNROLL quads a thread at a time, the next ones loaded before the
// current ones' reads. The `head` indices before the first 16-byte
// boundary and the < 4 after the last quad go one at a time. Every index
// is read once and every output written once.
__global__ void __launch_bounds__(CLUSTER_THREADS)
take_two_level_cluster_kernel(const int* __restrict__ table,
                              const int* __restrict__ idx,
                              int* __restrict__ out,
                              long long* __restrict__ cycles, int nt,
                              int slice, unsigned long long magic, int e,
                              int head, int64_t quads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long t0 = clock64();
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t tab =
      smem_u32(stage_slice(smem, table, nt, slice, cluster.block_rank()));
  const int4* idx4 = reinterpret_cast<const int4*>(idx + head);
  int4* out4 = reinterpret_cast<int4*>(out + head);
  const int64_t stride = (int64_t)gridDim.x * CLUSTER_THREADS;
  int64_t q = (int64_t)blockIdx.x * CLUSTER_THREADS + threadIdx.x;
  int4 j[TAKE_UNROLL];
#pragma unroll
  for (int u = 0; u < TAKE_UNROLL; ++u)
    j[u] = q + u * stride < quads ? __ldg(idx4 + q + u * stride)
                                  : make_int4(0, 0, 0, 0);
  stage_wait(smem, cluster);
  const long long t1 = clock64();
  for (; q < quads; q += TAKE_UNROLL * stride) {
    int4 next[TAKE_UNROLL], v[TAKE_UNROLL];
#pragma unroll
    for (int u = 0; u < TAKE_UNROLL; ++u) {
      const int64_t r = q + (u + TAKE_UNROLL) * stride;
      next[u] = r < quads ? __ldg(idx4 + r) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < TAKE_UNROLL; ++u)
      if (q + u * stride < quads)
        v[u] = make_int4(slice_entry(tab, j[u].x, slice, magic),
                         slice_entry(tab, j[u].y, slice, magic),
                         slice_entry(tab, j[u].z, slice, magic),
                         slice_entry(tab, j[u].w, slice, magic));
#pragma unroll
    for (int u = 0; u < TAKE_UNROLL; ++u) {
      if (q + u * stride < quads) out4[q + u * stride] = v[u];
      j[u] = next[u];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {  // the head and the tail
    const int t = threadIdx.x;
    const int64_t tail = e - head - 4 * quads;
    const int64_t i = t < 4 ? (t < head ? t : -1)
                            : (t - 4 < tail ? head + 4 * quads + (t - 4) : -1);
    if (i >= 0) out[i] = slice_entry(tab, idx[i], slice, magic);
  }
  cluster.sync();  // no block leaves while its cluster may still read it
  record_spans(cycles, t0, t1, cluster);
}

// ---------------------------------------------------------------------------
// V2. out[i, j] = tab[idx[i, j] / 128, j]. Lane j only ever reads column j,
// so the columns cut the table into parts that need no cluster: a block
// owns a group of C columns (a slab of R x C entries, R = nt / 128 rows,
// in its shared memory) and serves every read of those columns with
// ld.shared. A persistent grid of `groups` x nb blocks (nb at most the SMs
// a group gets, one block an SM), block b owning group b % groups. Each
// stages its slab by 16-byte cp.async (4-byte where the table is not
// 16-byte aligned) of its part of each table row, and while those are in
// flight loads its first index rows. A warp takes 32 / C index rows at
// once, C lanes a row: lane l reads idx[i, c0 + l % C] (coalesced), looks
// up slab[(idx >> 7) C + l % C] and stores out[i, c0 + l % C]. At C = 32
// bank = lane, so a warp's reads meet no bank conflict; at C = 16 two rows
// share a warp, and a read conflicts when both rows' table rows have the
// same parity. SLAB_UNROLL index rows are in flight a lane, the next ones
// loaded before the current ones' reads. `cycles` (optional, 3 int64)
// receives block 0's staging and lookup spans in clock64 cycles and the
// blocks launched.
//
// What bounds it: staging (blocks x 4 R C bytes from L2, 13.2 MB at C = 32
// and one block on each of 132 SMs) and the index rows in and the outputs
// out (8 bytes an index) from device memory.
constexpr int SLAB_THREADS = 1024;
constexpr int SLAB_WARPS = SLAB_THREADS / 32;
constexpr int SLAB_UNROLL = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

template <int C>
__global__ void __launch_bounds__(SLAB_THREADS, 1)
take_axis0_slab_kernel(const int* __restrict__ tab,
                       const int* __restrict__ idx, int* __restrict__ out,
                       long long* __restrict__ cycles, int rows, int m) {
  extern __shared__ __align__(16) int slab[];
  constexpr int GROUPS = LANES / C, PER_WARP = 32 / C, QUADS = C / 4;
  const long long t0 = clock64();
  const int c0 = (blockIdx.x % GROUPS) * C;
  const int nb = gridDim.x / GROUPS, bg = blockIdx.x / GROUPS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if ((reinterpret_cast<uintptr_t>(tab) & 15) == 0) {
    for (int qi = threadIdx.x; qi < rows * QUADS; qi += SLAB_THREADS) {
      const int r = qi / QUADS, c = 4 * (qi % QUADS);
      cp_async16(slab + r * C + c, tab + (int64_t)r * LANES + c0 + c);
    }
  } else {
    for (int x = threadIdx.x; x < rows * C; x += SLAB_THREADS)
      cp_async4(slab + x, tab + (int64_t)(x / C) * LANES + c0 + x % C);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int col = lane % C;
  const int stride = nb * SLAB_WARPS * PER_WARP;  // rows a pass of the group
  int i = (bg * SLAB_WARPS + warp) * PER_WARP + lane / C;
  int j[SLAB_UNROLL];
#pragma unroll
  for (int u = 0; u < SLAB_UNROLL; ++u) {
    const int row = i + u * stride;
    j[u] = row < m ? __ldg(idx + (int64_t)row * LANES + c0 + col) : 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const long long t1 = clock64();
  for (; i < m; i += SLAB_UNROLL * stride) {
    int next[SLAB_UNROLL];
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u) {
      const int row = i + (u + SLAB_UNROLL) * stride;
      next[u] = row < m ? __ldg(idx + (int64_t)row * LANES + c0 + col) : 0;
    }
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u) {
      const int row = i + u * stride;
      if (row < m)
        out[(int64_t)row * LANES + c0 + col] = slab[(j[u] >> 7) * C + col];
      j[u] = next[u];
    }
  }
  if (cycles != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = clock64() - t1;
    cycles[2] = gridDim.x;
  }
}

// x / d == (x * magic) >> 40 for x * d < 2^40 (x < 2^19 for every table
// that a cluster holds)
inline unsigned long long div_magic(int d) {
  return d > 0 ? ((1ull << 40) + d - 1) / d : 0;
}

// How many clusters of `cfg` the card holds at once, for each kernel,
// device, cluster size and shared memory: cudaOccupancyMaxActiveClusters
// once, after raising the kernel's shared-memory limit to the device's
// opt-in maximum, then from the cache.
struct ClusterFit {
  const void* kernel;
  int device, blocks, smem, clusters;
};

int clusters_held(const void* kernel, const cudaLaunchConfig_t& cfg,
                  int blocks, int* clusters) {
  static std::mutex mu;
  static std::vector<ClusterFit> fits;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(mu);
  for (const ClusterFit& f : fits)
    if (f.kernel == kernel && f.device == device && f.blocks == blocks &&
        f.smem == smem) {
      *clusters = f.clusters;
      return 0;
    }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  fits.push_back({kernel, device, blocks, smem, *clusters});
  return 0;
}

// The current device's SM count: cudaDevAttrMultiProcessorCount once a
// device, then from the cache.
int sm_count(int* sms) {
  static std::mutex mu;
  static std::vector<std::pair<int, int>> seen;  // (device, SMs)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : seen)
    if (d.first == device) {
      *sms = d.second;
      return 0;
    }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  seen.emplace_back(device, *sms);
  return 0;
}

// Launch `kernel` as persistent clusters of `blocks` blocks of `threads`
// threads with `smem` bytes of dynamic shared memory each: as many
// clusters as the card holds at once (`clusters_held`), at most `most`.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int threads, int blocks,
                    int smem, int64_t most, cudaStream_t stream,
                    Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const int err = clusters_held(reinterpret_cast<const void*>(kernel), cfg,
                                blocks, &clusters);
  if (err != 0) return err;
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (clusters > most) clusters = static_cast<int>(most < 1 ? 1 : most);
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * blocks));
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return last_error();
}

// the plan's slices must cover the table and fit the shared memory
inline bool plan_holds(int nt, int blocks, int slice, int smem) {
  return blocks >= 1 && blocks <= 8 && slice % 4 == 0 &&
         (int64_t)blocks * slice >= nt &&
         BARRIER_BYTES + 4 * (int64_t)slice <= smem;
}

// V2's grid: `groups` column groups, each on at most the SMs it gets (one
// block an SM) and on no more blocks than it has work for
template <int C>
int launch_slab(const int* tab, const int* idx, int* out, long long* cycles,
                int rows, int m, int smem, cudaStream_t stream) {
  constexpr int GROUPS = LANES / C;
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  const int per_pass = SLAB_WARPS * (32 / C);
  int nb = sms / GROUPS;
  if (nb > (m + per_pass - 1) / per_pass) nb = (m + per_pass - 1) / per_pass;
  if (nb < 1) nb = 1;
  err = static_cast<int>(cudaFuncSetAttribute(
      take_axis0_slab_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem));
  if (err != 0) return err;
  take_axis0_slab_kernel<C><<<nb * GROUPS, SLAB_THREADS, smem, stream>>>(
      tab, idx, out, cycles, rows, m);
  return last_error();
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
                          void* cycles, int nt, int e, int head, int quads,
                          int blocks, int slice, int smem, void* stream) {
  if (e <= 0) return 0;
  if (!plan_holds(nt, blocks, slice, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_cluster = (int64_t)blocks * CLUSTER_THREADS * TAKE_UNROLL;
  return launch_clusters(
      take_two_level_cluster_kernel, CLUSTER_THREADS, blocks, smem,
      (quads + per_cluster - 1) / per_cluster,
      static_cast<cudaStream_t>(stream), static_cast<const int*>(table),
      static_cast<const int*>(idx), static_cast<int*>(out),
      static_cast<long long*>(cycles), nt, slice, div_magic(slice), e, head,
      (int64_t)quads);
}

int access_take_scalar(const void* table, const void* idx, void* out,
                       void* cycles, int n, int e, int blocks, int head,
                       int slice, int smem, void* stream) {
  if (e <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      take_scalar_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(SCALAR_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, take_scalar_cluster_kernel,
                           static_cast<const int*>(table),
                           static_cast<const int*>(idx),
                           static_cast<int*>(out),
                           static_cast<long long*>(cycles), n, e, head, slice,
                           div_magic(slice));
  if (err != cudaSuccess) return static_cast<int>(err);
  return last_error();
}

int access_scatter_min(const void* idx, const void* val, void* out, int nt,
                       int e, int head, int quads, int fill, void* stream) {
  if (nt <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_trigger_kernel<<<grid_for((nt + 3) / 4), THREADS, 0, s>>>(
      static_cast<int*>(out), nt, fill);
  int err = last_error();
  if (err != 0 || e <= 0) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_for(quads));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t lerr = cudaLaunchKernelEx(
      &cfg, scatter_min_merged_kernel, static_cast<const int*>(idx),
      static_cast<const int*>(val), static_cast<int*>(out), head,
      (int64_t)quads, (int64_t)e);
  if (lerr != cudaSuccess) return static_cast<int>(lerr);
  return last_error();
}

int access_sm_clock_khz(int device, int* khz) {
  return static_cast<int>(
      cudaDeviceGetAttribute(khz, cudaDevAttrClockRate, device));
}

int access_take2d(const void* tab, const void* idx, void* out, void* cycles,
                  int m, void* stream) {
  if (m <= 0) return 0;
  // one wave of blocks at most (2048 threads an SM), no more than the rows
  int sms = 0;
  int err = sm_count(&sms);
  if (err != 0) return err;
  const int need = (m + V1_WARPS - 1) / V1_WARPS;
  const int wave = sms * (2048 / V1_THREADS);
  take2d_kernel<<<need < wave ? need : wave, V1_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int4*>(idx),
      static_cast<int4*>(out), static_cast<long long*>(cycles), m);
  return last_error();
}

int access_take_axis0(const void* tab, const void* idx, void* out,
                      void* cycles, int nt, int m, int cols, int groups,
                      int smem, void* stream) {
  if (m <= 0) return 0;
  const int rows = nt / LANES;
  if (nt % LANES != 0 || groups * cols != LANES ||
      4 * (int64_t)rows * cols > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* t = static_cast<const int*>(tab);
  const int* i = static_cast<const int*>(idx);
  int* o = static_cast<int*>(out);
  long long* c = static_cast<long long*>(cycles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 32: return launch_slab<32>(t, i, o, c, rows, m, smem, s);
    case 16: return launch_slab<16>(t, i, o, c, rows, m, smem, s);
    case 8: return launch_slab<8>(t, i, o, c, rows, m, smem, s);
    case 4: return launch_slab<4>(t, i, o, c, rows, m, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
