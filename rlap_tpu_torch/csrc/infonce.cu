// Fused identity-positive InfoNCE on Hopper: forward, dA and dB.
//
// Replaces the three Pallas TPU kernels of rlap_tpu/ops/infonce_pallas.py
// (the kernels named first take f <= 128 with f % 4 == 0 and 16-byte
// aligned rows, the others every other width up to 1920):
//   infonce_fwd_wgmma_kernel, infonce_fwd_kernel
//       <- _fwd_kernel     (:37-67,   launched :139-156)
//   infonce_bwd_wgmma_kernel<false>, infonce_bwd_kernel<WARPS, false>
//       <- _bwd_da_kernel  (:86-101,  launched :176-190)
//   infonce_bwd_wgmma_kernel<true>, infonce_bwd_kernel<WARPS, true>
//       <- _bwd_db_kernel  (:104-121, launched :192-206)
// and, for both directions of the dual-branch loss at once (f <= 128,
// f % 4 == 0, 16-byte aligned rows), where the JAX package runs the three
// twice:
//   infonce_fwd_pair_wgmma_kernel + infonce_fwd_pair_merge_kernel
//       <- _fwd_kernel twice
//   infonce_bwd_pair_wgmma_kernel, launched twice
//       <- _bwd_da_kernel and _bwd_db_kernel, twice each
//
// A and B are L2-normalised float32 [n, f] row-major. With
// sim_ij = A_i . B_j / tau:
//   forward: lse_i = logsumexp_j sim_ij,  out_i = sim_ii - lse_i
//   backward, with coef_ij = (g_i / tau) (1[i == j] - exp(sim_ij - lse_i)):
//     dA_i = sum_j coef_ij B_j,   dB_j = sum_i coef_ij A_i
// The n x n similarity matrix never reaches device memory: each tile is
// recomputed from A and B where it is needed (the flash recompute).
//
// The pair. The dual-branch loss 0.5 (l(A, B) + l(B, A)) takes its second
// direction on B A^T / tau, the transpose of the first's sim. So one pass
// over sim gives both directions' values: lse1 its row logsumexps, lse2
// its column ones, out1_i = sim_ii - lse1_i and out2_j = sim_jj - lse2_j.
// And the gradient of the pair through sim is one coefficient matrix,
//   G_ij = (g1_i / tau) (1[i == j] - exp(sim_ij - lse1_i))
//        + (g2_j / tau) (1[i == j] - exp(sim_ij - lse2_j)),
// with dA = G B and dB = G^T A: one launch that owns rows of A and streams
// B, one that owns rows of B and streams A. Each recomputes sim once, as a
// one-way launch does, where the two directions one way take four.
//
// What bounds them on the H100: operations. The forward does 2 n^2 f
// useful FLOPs and each backward kernel 4 n^2 f, while the bytes are
// O(n f). No atomics anywhere: a block owns its output rows, so all three
// kernels are deterministic.
//
// ---- 3xTF32: the arithmetic of all of them
//
// They run their products on the tensor cores in TF32. One TF32 pass keeps
// 10 mantissa bits, about three decimal digits, and would break the
// tolerances these kernels are held to (values rtol 1e-5, gradients rtol
// 1e-4, 1e-4 of the largest entry against float64 on alike rows). So every
// operand x is split into hi + lo, both TF32, with |x - hi - lo| <=
// 2^-21 |x|, and a product p q is taken as lo_p hi_q + hi_p lo_q +
// hi_p hi_q, the two small terms first, into float32 accumulators;
// lo_p lo_q is dropped. A product of two TF32 values is exact in float32,
// so this recovers float32 accuracy at a third of the TF32 rate: 165 of
// the card's 495 TFLOP/s, against 67 TFLOP/s of float32 FMA outside the
// tensor cores. The tensor cores read the top 19 bits of a TF32 operand
// and ignore the rest, which both splits below use; cvt.rna.tf32.f32 is
// not used, because it compiles to about a dozen integer instructions on
// this card.
//
// ---- infonce_fwd_wgmma_kernel: the forward at f <= 128, f % 4 == 0
//
// wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32, the only route to
// the card's full tensor-core rate, and asynchronous: the threads do other
// work while it runs. A block of two warpgroups owns 128 rows of A and
// holds them in registers for its whole life, as the A operand (hi = the
// values themselves, which the tensor core cuts to TF32; lo = the rest,
// rounded to TF32). Tiles of 64 rows of B stream through a ring of 4
// stages filled by cp.async, 16 bytes a thread, straight into the layout
// that wgmma reads from shared memory: panels of 32 features, rows of 128
// bytes, the 16-byte chunks of a row permuted by the row's low bits (the
// 128-byte swizzle). The stage is its own hi plane; all threads then write
// the tile's lo plane, once for the block (two planes). While the tensor
// cores take tile j, the threads split tile j + 1 and start the copy of
// tile j + 3; one __syncthreads per tile. Rows and columns past n and
// features past f are zero-filled by the copy (source size 0). 197,632
// bytes of dynamic shared memory, opted into with cudaFuncSetAttribute;
// one block an SM.
//
// Forward epilogue (both forward kernels). The accumulator gives a lane
// two rows (g, g + 8 of its warp's 16; g = lane / 4, t = lane % 4) and
// columns 2 t, 2 t + 1 of each 8. Each lane runs its own online softmax
// over the columns it sees, in base 2 on logits scaled by log2(e) / tau,
// with max, sum and positive in registers; the four lanes of a quad are
// merged by shuffles once, after the last tile.
//
// ---- infonce_fwd_pair_wgmma_kernel: both directions' forward
//
// The forward's tiles, ring and products. The epilogue makes
// e_ij = exp(sim_ij - 1/tau) once and sums it along rows (lse1) and along
// columns (lse2). A fixed shift takes the place of the running max: unit
// rows give |sim_ij| <= 1/tau, so e_ij <= 1, and e_ij >= exp(-2/tau) stays
// a normal float32 for tau >= 0.025 (the caller takes two one-way forwards
// below that). The row sums stay in registers as above. A column's sum
// crosses the blocks, so each block writes its own: the lanes that share
// a column (the eight g of one t) add their sums with a butterfly of 14
// shuffles, the eight warps' partials go through shared memory, and the
// block's sum of each column over its 128 rows goes to its row of a
// [blocks, n] workspace. infonce_fwd_pair_merge_kernel then adds each
// column's partials in float64, in block order. No atomics: the pair is
// deterministic, as the one-way kernels are.
//
// ---- infonce_bwd_wgmma_kernel<DB>: dA (DB false) and dB (DB true) at
// ---- f <= 128, f % 4 == 0
//
// Both products on wgmma, by a warpgroup that issues them and one that
// feeds it; its own note, at the kernel, says how. What is summed is the
// same as in the mma.sync kernel below.
//
// ---- infonce_bwd_pair_wgmma_kernel: G P_rows at f <= 128, f % 4 == 0
//
// dB's kernel with both anchors' terms in its coefficients: the owned
// rows' (lse and g in registers, as dA) and the streamed rows' (read a
// tile ahead, as dB). Launched as (P, Q) = (A, B) with (lse1, g1 | lse2,
// g2) it gives dA, as (B, A) with (lse2, g2 | lse1, g1) dB.
//
// ---- infonce_fwd_kernel and infonce_bwd_kernel<WARPS, DB>: the forward,
// ---- dA and dB at other widths, mma.sync
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with both operands
// split in registers (Veltkamp's split: hi rounded to TF32 by three
// float32 operations, lo = x - hi exact, cut by the tensor core). On this
// card shared-memory loads overlap with mma.sync but float32 arithmetic
// hardly does, so the splits cost most of their instruction count on top
// of the tensor cores' time; that, and the 280 TFLOP/s that mma.sync
// reaches here (both measured on this card), is what
// holds these kernels back, and why the main shape moved to wgmma. They
// stay for the widths wgmma's layouts do not take here (f > 128, or rows
// that are not 16-byte aligned).
//
// Write P for the rows a block owns and Q for the rows its tiles stream:
// A and B for the forward and dA, B and A for dB (the anchor index i,
// which carries lse_i and g_i, is then the tile's column).
//
// Tiles and shared memory. A block of 8 warps owns 128 rows of P (16 a
// warp) and keeps them in shared memory for its whole life; tiles of 64
// rows of Q stream through a ring of 3 stages filled by cp.async, 16 bytes
// a thread (4 bytes when f % 4 != 0 or a pointer is not 16-byte aligned),
// with one __syncthreads per stage: the copy of tile j + 2 is in flight
// while tile j is multiplied. Rows, columns and features past the matrix
// are zero-filled by the copy, so the caller pads nothing. A row of a tile
// holds up to 128 features at a stride of 132 floats; at f <= 128 that is
// 128 x 132 x 4 = 67,584 bytes of resident rows and 3 x 64 x 132 x 4 =
// 101,376 bytes of ring: 168,960 bytes of dynamic shared memory, one block
// an SM. For f > 128 the features are cut into chunks of 128: all chunks
// of the block's rows stay resident, a ring stage holds one chunk of a Q
// tile, and the block owns fewer rows so that it fits: 64 rows (4 warps)
// up to f = 384, 32 up to 896, 16 up to 1920. A wider f does not fit and
// the launcher returns cudaErrorInvalidValue.
//
// The fragment permutation. Which feature sits in which k slot of an mma
// is free, as long as both operands agree: k is the summation index. A
// lane reads features 8 t .. 8 t + 7 of each block of 32 with two 128-bit
// loads, and feeds them to four k-steps as (k = t, k = t + 4) =
// (8 t + 2 s, 8 t + 2 s + 1), s = 0..3. With the stride of 132 floats
// (132 mod 32 = 4) the eight lanes of a quarter warp hit eight different
// groups of four banks: no conflict, and a quarter of the load
// instructions of the element-wise fragment layout.
//
// The gradients: the coefficient tile goes from the accumulator straight
// to the A operand of the second product, grad_tile += coef . Q_tile,
// without touching shared memory. The accumulator layout (columns 2 t,
// 2 t + 1) is not the A fragment's (k = t, t + 4), but the column index is
// the summation index of the second product: its B fragment reads rows
// 8 j + 2 t and 8 j + 2 t + 1 of the same float32 tile, and nothing moves.
// Along the features the lane reads 4 g .. 4 g + 3 of each block of 32
// with one 128-bit load a row, which serves four n-tiles (n = g stands
// for feature 32 m + 4 g + q); a lane's outputs are then 8 contiguous
// floats a row and block of 32. A block covers 128 output features
// (grid.y over feature chunks, and the chunk order of the similarity ends
// with the block's own, so that its stage is at hand).
//
// The gradients: what is summed. Let r be the row of Q at the block's
// first own index. On alike rows (a freshly initialised encoder) the sums
// cancel nearly equal terms, and the tensor cores add in float32 with
// truncation, not round-to-nearest. So:
// (a) The similarity of a tile is taken against Q - r, and t = P_row . r
//     (in float64, kept as float32 hi + lo) is added back before the
//     exponent. A similarity near 1 summed by truncating adds comes out
//     low by about the same amount for every pair, which scales every
//     coefficient alike: dA's sum absorbs that (see (c)), dB's does not,
//     and on rows alike to 0.003 it would cost dB more than the 2e-4 of
//     its largest entry that it is held to (tests/test_torch_infonce_3xtf32.py
//     shows it in an emulation of the truncating adds). Against Q - r the
//     similarity is of the size of the rows' differences, and so is what
//     the truncation takes. The forward needs no shift: its lse comes from
//     the same similarities, and a common error cancels in s_ii - lse_i.
// (b) Each tile's second product starts from a zero accumulator and is
//     added to the running total with a float32 add (the two-level sum):
//     rounding grows with the number of tiles, not of terms, and no chain
//     of truncations is longer than a tile's.
// (c) The second product sums coef_ij (Q - r), every term of the size of
//     the rows' differences. dA: the coefficients of a row i sum to 0 when
//     lse_i is its logsumexp, so the sum is dA_i, and what is left of the
//     float32 rounding, of lse_i's own rounding and of the accumulators'
//     truncation scales with the result. dB: the coefficients of a column
//     j sum to c_j != 0 (the softmax runs over j for each i), so the sum
//     is dB_j - r c_j, and the kernel adds r c_j back at the end. c_j is
//     summed in float32 within a tile and in float64 across tiles: a
//     float32 running total of c_j loses more at n = 20000 than the shift
//     saves. The pair: the streamed rows' terms do not sum to 0 along a
//     row, as in dB, so both of its launches add r c back, c summed over
//     those terms alone; the owned rows' terms sum to 0, as in dA, and
//     what their sum is off by rounding stays out of c and of the result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ===========================================================================
// the forward, dA and dB at other widths: tensor cores, 3xTF32 through
// mma.sync (the copies and splits serve the wgmma kernels too)
// ===========================================================================

constexpr int TN = 64;           // rows of B in a ring stage (tile columns)
constexpr int KC = 128;          // features in a chunk
constexpr int LD = KC + 4;       // row stride in shared memory, floats
constexpr int NST = 3;           // ring stages
constexpr int STAGE = TN * LD;   // floats in a stage
constexpr int MAX_CHUNKS = 15;   // 16 resident rows x 15 chunks still fit

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Features of chunk c that are read: up to the next multiple of 32 past f.
__device__ __forceinline__ int chunk_width(int c, int f) {
  const int left = f - c * KC;
  return left >= KC ? KC : (left + 31) / 32 * 32;
}

// dst[row * LD + k] = x[r0 + row][k0 + k] for row < rows, k < kf, as
// asynchronous copies; zero outside the [n, f] matrix. `vec`: 16-byte
// copies (f % 4 == 0 and x 16-byte aligned): a lane keeps its 4 features
// and a warp walks down the rows, so a copy costs a few instructions.
// Else 4-byte copies, element by element.
template <int THREADS>
__device__ __forceinline__ void load_rows_async(float* dst,
                                                const float* __restrict__ x,
                                                int r0, int rows, int k0,
                                                int kf, int n, int f,
                                                bool vec) {
  if (vec) {
    const int k = 4 * (threadIdx.x % 32), first = threadIdx.x / 32;
    if (k >= kf) return;
    const bool k_in = k0 + k < f;
    const float* src = x + (int64_t)(r0 + first) * f + k0 + k;
    float* d = dst + first * LD + k;
#pragma unroll 4
    for (int row = first; row < rows; row += THREADS / 32) {
      const bool in = k_in && r0 + row < n;
      cp_async16(d, in ? src : x, in ? 16 : 0);
      src += (int64_t)(THREADS / 32) * f;
      d += (THREADS / 32) * LD;
    }
  } else {
    for (int e = threadIdx.x; e < rows * KC; e += THREADS) {
      const int row = e / KC, k = e % KC;
      if (k >= kf) continue;
      const bool in = r0 + row < n && k0 + k < f;
      cp_async4(dst + row * LD + k,
                in ? x + (int64_t)(r0 + row) * f + k0 + k : x, in ? 4 : 0);
    }
  }
}

// x = hi + lo with hi = x rounded to nearest at TF32's 11 significant
// bits, lo = x - hi (exact): Veltkamp's split, three float32 operations
// and one more. lo keeps up to 13 significant bits, which the tensor
// core cuts to 11: |x - hi - lo| <= 2^-21 |x|. Needs |x| < 2^114 (the rows
// are unit vectors).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.f);  // 2^13 + 1
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// d += a b for one m16n8k8 tile: a is [16, 8] row-major fragments, b is
// [8, 8] column-major fragments, d is [16, 8] in float32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void unpack8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// s[j] += P_w (Q_j - r)^T over kf features, in 3xTF32: P_w are the warp's
// 16 rows (pw, stride LD), Q_j rows 8 j .. 8 j + 7 of the stage qs, and r
// the row at rq in device memory (rf of its features lie in the chunk; the
// rest count as 0) when SHIFT, else 0. s[j][e] is row g + 8 (e / 2),
// column 8 j + 2 t + e % 2 of the 16 x 64 tile.
template <bool SHIFT>
__device__ __forceinline__ void s_tile_mma(float (&s)[8][4],
                                           const float* pw, const float* qs,
                                           const float* __restrict__ rq,
                                           int rf, int kf, int g, int t) {
  const float* pa = pw + g * LD + 8 * t;
  const float* qa = qs + g * LD + 8 * t;
#pragma unroll 1
  for (int kb = 0; kb < kf; kb += 32) {
    uint32_t ah[4][4], al[4][4];  // [k-step][a0..a3]
    {
      float x[8], y[8];  // rows g and g + 8
      unpack8(pa + kb, x);
      unpack8(pa + 8 * LD + kb, y);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        split_tf32(x[2 * ks], ah[ks][0], al[ks][0]);
        split_tf32(y[2 * ks], ah[ks][1], al[ks][1]);
        split_tf32(x[2 * ks + 1], ah[ks][2], al[ks][2]);
        split_tf32(y[2 * ks + 1], ah[ks][3], al[ks][3]);
      }
    }
    float r8[8];  // r at this lane's features of the block of 32
    if constexpr (SHIFT) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = kb + 8 * t + e;
        r8[e] = k < rf ? __ldg(rq + k) : 0.f;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float z[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unpack8(qa + (4 * half + q) * 8 * LD + kb, z[q]);
        if constexpr (SHIFT) {
#pragma unroll
          for (int e = 0; e < 8; ++e) z[q][e] -= r8[e];
        }
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split_tf32(z[q][2 * ks], bh[q][0], bl[q][0]);
          split_tf32(z[q][2 * ks + 1], bh[q][1], bl[q][1]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_tf32(s[4 * half + q], al[ks], bh[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_tf32(s[4 * half + q], ah[ks], bl[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_tf32(s[4 * half + q], ah[ks], bh[q]);
      }
    }
  }
}

// acc += coef (Q - r) for the warp's 16 x 64 coefficient tile (in the
// accumulator layout of s_tile_mma) and the 64 rows of the stage qs, over
// kfo output features, in 3xTF32. acc[4 m + q][e] is row g + 8 (e / 2),
// feature 32 m + 8 t + 4 (e % 2) + q; r[m][q] is feature 32 m + 4 g + q of
// the row that is subtracted. Each half of the features is summed from
// zero and then added to acc (the two-level sum).
__device__ __forceinline__ void coef_mma(float (&acc)[16][4],
                                         const float (&coef)[8][4],
                                         const float* qs,
                                         const float (&r)[4][4], int kfo,
                                         int g, int t) {
  const float* qb = qs + 2 * t * LD + 4 * g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (64 * h >= kfo) break;
    float part[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // k = t is tile column 8 j + 2 t, k = t + 4 is column 8 j + 2 t + 1
      uint32_t ah[4], al[4];
      split_tf32(coef[j][0], ah[0], al[0]);
      split_tf32(coef[j][2], ah[1], al[1]);
      split_tf32(coef[j][1], ah[2], al[2]);
      split_tf32(coef[j][3], ah[3], al[3]);
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const int m = 2 * h + mm;
        if (32 * m >= kfo) break;
        const float4 u0 =
            *reinterpret_cast<const float4*>(qb + 8 * j * LD + 32 * m);
        const float4 u1 =
            *reinterpret_cast<const float4*>(qb + (8 * j + 1) * LD + 32 * m);
        const float v0[4] = {u0.x, u0.y, u0.z, u0.w};
        const float v1[4] = {u1.x, u1.y, u1.z, u1.w};
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split_tf32(v0[q] - r[m][q], bh[q][0], bl[q][0]);
          split_tf32(v1[q] - r[m][q], bh[q][1], bl[q][1]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_tf32(part[4 * mm + q], al, bh[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_tf32(part[4 * mm + q], ah, bl[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma_tf32(part[4 * mm + q], ah, bh[q]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[8 * h + i][e] += part[i][e];
  }
}

// The main loop of the mma.sync kernels. The block's rows [r0, r0 + 16
// WARPS) of P are made resident, all chunks; then for each tile of 64 rows
// of Q and each feature chunk, in an order that ends with chunk `last`,
// the stage is awaited, the copy two steps ahead is started, and the
// warp's 16 x 64 similarity tile is advanced, against Q - Q[r0] when
// SHIFT. `tile_done(s, c0, stage)` runs once a tile's similarities are
// complete, with the stage that holds chunk `last` of its rows.
template <int WARPS, bool SHIFT, typename TileDone>
__device__ __forceinline__ void for_each_tile(const float* __restrict__ P,
                                              const float* __restrict__ Q,
                                              int n, int f, bool vec,
                                              int last, float* smem,
                                              TileDone tile_done) {
  constexpr int BM = 16 * WARPS, THREADS = 32 * WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * BM;
  const int nch = (f + KC - 1) / KC;
  const int nsteps = (n + TN - 1) / TN * nch;
  float* ps = smem;
  float* ring = smem + BM * nch * LD;

  for (int c = 0; c < nch; ++c)
    load_rows_async<THREADS>(ps + c * BM * LD, P, r0, BM, c * KC,
                             chunk_width(c, f), n, f, vec);
  // step -> (tile, chunk): chunks run last + 1, ..., nch - 1, 0, ..., last
  int ld_step = 0, ld_tile = 0, ld_i = 0;
  auto load_next = [&]() {
    if (ld_step < nsteps) {
      const int c = (last + 1 + ld_i) % nch;
      load_rows_async<THREADS>(ring + (ld_step % NST) * STAGE, Q, ld_tile * TN,
                               TN, c * KC, chunk_width(c, f), n, f, vec);
      ++ld_step;
      if (++ld_i == nch) ld_i = 0, ++ld_tile;
    }
    cp_async_commit();
  };
  for (int s = 0; s < NST - 1; ++s) load_next();

  float sacc[8][4];
  int i = 0, tile = 0;
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // this step's stage has landed; the last one is free
    load_next();
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    }
    const int c = (last + 1 + i) % nch;
    const float* stage = ring + (step % NST) * STAGE;
    s_tile_mma<SHIFT>(sacc, ps + (c * BM + 16 * warp) * LD, stage,
                      Q + (int64_t)r0 * f + c * KC, f - c * KC,
                      chunk_width(c, f), g, t);
    if (++i == nch) {
      tile_done(sacc, tile * TN, stage);
      i = 0, ++tile;
    }
  }
  cp_async_wait<0>();
}

// The forward's state for rows row0 + g and row0 + g + 8 of a warp, as one
// lane sees them (columns 2 t, 2 t + 1 of each 8): the running max and sum
// in base 2 on logits scaled by log2(e) / tau, and the positive in natural
// units. The four lanes of a quad are merged in `store`.
struct RowSoftmax {
  float m2[2] = {NEG_BIG, NEG_BIG}, sum[2] = {0.f, 0.f}, pos[2] = {0.f, 0.f};

  // s[j][e]: row row0 + g + 8 (e / 2), column c0 + 8 j + 2 t + e % 2.
  __device__ __forceinline__ void add_tile(float (&s)[8][4], int c0, int row0,
                                           int g, int t, int n,
                                           float inv_tau) {
    if (c0 < row0 + 16 && c0 + TN > row0) {  // the diagonal crosses
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + 2 * t + (e & 1) == row0 + g + 8 * (e >> 1))
            pos[e >> 1] += s[j][e] * inv_tau;
    }
    const float scale2 = inv_tau * LOG2E;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    if (c0 + TN > n) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + 2 * t + (e & 1) >= n) s[j][e] = NEG_BIG;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m_new = m2[h];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        m_new = fmaxf(m_new, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part += exp2f(s[j][2 * h] - m_new) + exp2f(s[j][2 * h + 1] - m_new);
      sum[h] = sum[h] * exp2f(m2[h] - m_new) + part;
      m2[h] = m_new;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ out,
                                        float* __restrict__ lse, int row0,
                                        int g, int t, int n) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m_all = m2[h];
      m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, 1));
      m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, 2));
      float s_all = sum[h] * exp2f(m2[h] - m_all);
      s_all += __shfl_xor_sync(0xffffffffu, s_all, 1);
      s_all += __shfl_xor_sync(0xffffffffu, s_all, 2);
      float p = pos[h];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int row = row0 + g + 8 * h;
      if (t == 0 && row < n) {
        const float l = fmaf(m_all, LN2, logf(s_all));
        lse[row] = l;
        out[row] = p - l;
      }
    }
  }
};

template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 1)
infonce_fwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ out, float* __restrict__ lse, int n,
                   int f, float inv_tau, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * 16 * WARPS + 16 * warp;  // the warp's rows
  RowSoftmax rows;
  for_each_tile<WARPS, false>(
      A, B, n, f, vec, (f + KC - 1) / KC - 1, smem,
      [&](float (&s)[8][4], int c0, const float*) {
        rows.add_tile(s, c0, row0, g, t, n, inv_tau);
      });
  rows.store(out, lse, row0, g, t, n);
}

// ---------------------------------------------------------------------------
// the forward at f <= 128, f % 4 == 0: wgmma
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 256;   // two warpgroups, 64 rows of A each
constexpr int WG_RING = 4;        // stages of B tiles
constexpr int PANEL = TN * 32;    // floats in a panel: 64 rows x 32 features
constexpr int WG_STAGE = 4 * PANEL;
constexpr int WG_SMEM = sizeof(float) * (WG_RING + 2) * WG_STAGE + 1024;
constexpr int WG_ROWS = 128;      // rows of A a block owns
constexpr int WG_WARPS = WG_THREADS / 32;
// the pair adds two tiles' column sums of each warp
constexpr int WG_PAIR_SMEM = WG_SMEM + sizeof(float) * 2 * WG_WARPS * TN;

// The pair forward's sums for rows row0 + g and row0 + g + 8 of a warp, as
// one lane sees them (columns 2 t, 2 t + 1 of each 8): the row sums of
// e = exp(sim - 1/tau) and the positive in natural units; the four lanes
// of a quad are merged in `store`. `add_tile` also leaves the warp's
// column sums of the tile, over its 16 rows, in shared memory.
struct PairSums {
  float sum[2] = {0.f, 0.f}, pos[2] = {0.f, 0.f};

  // s[j][e]: row row0 + g + 8 (e / 2), column c0 + 8 j + 2 t + e % 2;
  // cols: the warp's TN column sums of this tile.
  __device__ __forceinline__ void add_tile(float (&s)[8][4], int c0, int row0,
                                           int g, int t, int n, float inv_tau,
                                           float* cols) {
    if (c0 < row0 + 16 && c0 + TN > row0) {  // the diagonal crosses
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + 2 * t + (e & 1) == row0 + g + 8 * (e >> 1))
            pos[e >> 1] += s[j][e] * inv_tau;
    }
    // 2^((s - 1) log2(e) / tau) = exp(sim - 1/tau)
    const float scale2 = inv_tau * LOG2E;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2f(fmaf(s[j][e], scale2, -scale2));
    if (c0 + TN > n || row0 + 16 > n) {  // the ragged last tile or rows
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * j + 2 * t + (e & 1) >= n ||
              row0 + g + 8 * (e >> 1) >= n)
            s[j][e] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) part += s[j][2 * h] + s[j][2 * h + 1];
      sum[h] += part;
    }
    // column 8 j + 2 t + u is v[2 j + u] in each of the eight lanes of one
    // t; halve the columns at each of three exchanges (lane bits 4, 3, 2
    // are g's bits 2, 1, 0), which leaves columns 8 g + 2 t + u in v[u]
    float v[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) v[2 * j + u] = s[j][u] + s[j][2 + u];
    fold<8>(v, g & 4, 16);
    fold<4>(v, g & 2, 8);
    fold<2>(v, g & 1, 4);
    *reinterpret_cast<float2*>(cols + 8 * g + 2 * t) = make_float2(v[0], v[1]);
  }

  // v[i] += the partner's v[i] (lane ^ lanes) for the half of v[0, 2 HALF)
  // this lane keeps (the upper when `up`), moved to v[0, HALF)
  template <int HALF>
  static __device__ __forceinline__ void fold(float (&v)[16], bool up,
                                              int lanes) {
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = up ? v[i] : v[i + HALF];
      const float keep = up ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, lanes);
    }
  }

  // lse1, out1 and the diagonal sim_ii of the lane's rows
  __device__ __forceinline__ void store(float* __restrict__ out,
                                        float* __restrict__ lse,
                                        float* __restrict__ diag, int row0,
                                        int g, int t, int n,
                                        float inv_tau) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s_all = sum[h];
      s_all += __shfl_xor_sync(0xffffffffu, s_all, 1);
      s_all += __shfl_xor_sync(0xffffffffu, s_all, 2);
      float p = pos[h];
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      const int row = row0 + g + 8 * h;
      if (t == 0 && row < n) {
        const float l = inv_tau + logf(s_all);
        lse[row] = l;
        out[row] = p - l;
        diag[row] = p;
      }
    }
  }
};

// A tile's column sums over the block's rows, from the warps' partials
// `cols` added in warp order, to the block's row of the workspace ws.
__device__ __forceinline__ void store_cols(const float* cols,
                                           float* __restrict__ ws, int c0,
                                           int n) {
  const int c = threadIdx.x;
  if (c < TN && c0 + c < n) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WG_WARPS; ++w) s += cols[w * TN + c];
    ws[(int64_t)blockIdx.x * n + c0 + c] = s;
  }
}

// Where features 4 c .. 4 c + 3 (c < 32) of row `row` of a tile lie in a
// stage, in floats: panels of 32 features, rows of 128 bytes in a panel,
// and the 16-byte chunks of a row permuted by the row's low three bits
// (the 128-byte swizzle that the wgmma descriptor below names).
__device__ __forceinline__ int swizzled(int row, int c) {
  return (c >> 3) * PANEL + row * 32 + (((c & 7) ^ (row & 7)) << 2);
}

// Shared-memory descriptor of a K-major operand with 128-byte swizzle:
// start address, leading offset 1 (unused), 1024 bytes from one group of
// 8 rows to the next, all in units of 16 bytes; layout type 1 at bit 62.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3ffff) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// d (+)= a b^T for a warpgroup: a is its 64 x 8 block of A in registers
// (this warp's 16 rows, the m16n8k8 fragment), b the 64 x 8 block of B
// that `desc` names; d[j][e] as in s_tile_mma. Asynchronous.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate)
      : "memory");
}

// d (+)= a b^T for a warpgroup, both operands in shared memory: a names a
// 64 x 8 block of A, b a 32 x 8 block of B; d[j][e] is row 16 w + g +
// 8 (e / 2) of the warpgroup's 64 (w its warp), column 8 j + 2 t + e % 2.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[4][4],
                                               uint64_t desc_a,
                                               uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// d (+)= a b^T for a warpgroup: a is its 64 x 8 block in registers (this
// warp's 16 rows, the m16n8k8 fragment), b a 128 x 8 block in shared
// memory; d[j][e] as above, j < 16.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[16][4],
                                                const uint32_t (&a)[4],
                                                uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate)
      : "memory");
}

// x minus x cut to TF32 (exact), rounded to TF32 by adding half an ulp to
// the bit pattern, which the tensor core's cut then finishes. With hi = x
// as the tensor core reads it, |x - hi - lo| <= 2^-21 |x|. Two of its
// three operations are integer ones, which issue at half the float32
// rate: fine here, where a value is split once for the block while wgmma
// runs, and slower than Veltkamp's split inside the mma.sync loop.
__device__ __forceinline__ uint32_t lo_of_cut(float x) {
  const float cut = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __float_as_uint(x - cut) + 0x1000u;
}

// Tile `tile` of B into a stage, as asynchronous 16-byte copies to their
// swizzled places; zero past the matrix. Chunks c < chunks are copied.
__device__ __forceinline__ void load_stage_swizzled(float* stage,
                                                    const float* __restrict__ B,
                                                    int tile, int chunks,
                                                    int n, int f) {
  const int c = threadIdx.x % 32;
  if (c >= chunks) return;
#pragma unroll 4
  for (int row = threadIdx.x / 32; row < TN; row += WG_THREADS / 32) {
    const int col = tile * TN + row;
    const bool in = col < n && 4 * c < f;
    cp_async16(stage + swizzled(row, c),
               in ? B + (int64_t)col * f + 4 * c : B, in ? 16 : 0);
  }
}

// One block: rows [128 b, 128 b + 128) of A, held in registers as the A
// operand of wgmma (hi = the values as the tensor core cuts them, and lo),
// against all tiles of 64 rows of B. A tile arrives by cp.async in the
// swizzled layout that wgmma reads, which serves as its hi plane; all
// threads then write its lo plane. While the tensor cores multiply tile j
// (48 wgmma at f = 128: three terms for each of 16 blocks of 8 features),
// the threads split tile j + 1 and start the copy of tile j + 3. One
// __syncthreads per tile. PAIR: the epilogue is `PairSums`, and while the
// tensor cores take tile j the first 64 threads add tile j - 1's column
// sums over the warps and store them to the block's row of ws (cols holds
// two tiles' sums, so that tile j's can be written meanwhile).
template <bool PAIR>
__device__ __forceinline__ void fwd_wgmma(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          float* __restrict__ out,
                                          float* __restrict__ lse,
                                          float* __restrict__ diag,
                                          float* __restrict__ ws, int n,
                                          int f, float inv_tau) {
  extern __shared__ float smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* lo = ring + WG_RING * WG_STAGE;  // two lo planes
  float* cols = lo + 2 * WG_STAGE;        // PAIR: [2][WG_WARPS][TN]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * WG_ROWS + 16 * warp;  // the warp's rows
  const int nk = (f + 7) / 8;                     // blocks of 8 features
  const int chunks = 2 * nk;                      // 16-byte chunks of a row
  const int ntiles = (n + TN - 1) / TN;

  auto load_tile = [&](int tile) {
    if (tile < ntiles)
      load_stage_swizzled(ring + (tile % WG_RING) * WG_STAGE, B, tile, chunks,
                          n, f);
    cp_async_commit();
  };
  auto split_tile = [&](int tile) {
    const float* stage = ring + (tile % WG_RING) * WG_STAGE;
    float* plane = lo + (tile % 2) * WG_STAGE;
    const int c = threadIdx.x % 32;
    if (c >= chunks) return;
#pragma unroll 4
    for (int row = threadIdx.x / 32; row < TN; row += WG_THREADS / 32) {
      const int off = swizzled(row, c);
      const float4 v = *reinterpret_cast<const float4*>(stage + off);
      *reinterpret_cast<uint4*>(plane + off) = make_uint4(
          lo_of_cut(v.x), lo_of_cut(v.y), lo_of_cut(v.z), lo_of_cut(v.w));
    }
  };
  for (int tile = 0; tile < WG_RING - 1; ++tile) load_tile(tile);

  // the A operand: for block s of 8 features, rows g and g + 8, features
  // 8 s + t and 8 s + t + 4
  uint32_t ah[16][4], al[16][4];
#pragma unroll
  for (int s = 0; s < 16; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1), k = 8 * s + t + 4 * (i >> 1);
      const float x = (row < n && k < f) ? A[(int64_t)row * f + k] : 0.f;
      ah[s][i] = __float_as_uint(x);
      al[s][i] = lo_of_cut(x);
    }

  cp_async_wait<WG_RING - 2>();
  __syncthreads();  // tile 0 has landed
  split_tile(0);

  RowSoftmax rows;
  PairSums sums;
  float d[8][4] = {};
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<WG_RING - 3>();  // this thread's copies of tile + 1
    // what this thread wrote (copies and lo) becomes visible to wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const float* stage = ring + (tile % WG_RING) * WG_STAGE;
    const float* plane = lo + (tile % 2) * WG_STAGE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      if (s >= nk) break;
      const int off = (s / 4) * PANEL + (s % 4) * 8;
      const uint64_t dh = wgmma_desc(stage + off);
      const uint64_t dl = wgmma_desc(plane + off);
      wgmma_tf32(d, al[s], dh, s > 0);  // the small terms first
      wgmma_tf32(d, ah[s], dl, 1);
      wgmma_tf32(d, ah[s], dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    load_tile(tile + WG_RING - 1);  // into the stage of tile - 1
    if (tile + 1 < ntiles) split_tile(tile + 1);
    if constexpr (PAIR)
      if (tile > 0)
        store_cols(cols + ((tile - 1) % 2) * WG_WARPS * TN, ws,
                   (tile - 1) * TN, n);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
    if constexpr (PAIR)
      sums.add_tile(d, tile * TN, row0, g, t, n, inv_tau,
                    cols + ((tile % 2) * WG_WARPS + warp) * TN);
    else
      rows.add_tile(d, tile * TN, row0, g, t, n, inv_tau);
  }
  cp_async_wait<0>();
  if constexpr (PAIR) {
    __syncthreads();  // the last tile's column sums
    store_cols(cols + ((ntiles - 1) % 2) * WG_WARPS * TN, ws,
               (ntiles - 1) * TN, n);
    sums.store(out, lse, diag, row0, g, t, n, inv_tau);
  } else {
    rows.store(out, lse, row0, g, t, n);
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
infonce_fwd_wgmma_kernel(const float* __restrict__ A,
                         const float* __restrict__ B, float* __restrict__ out,
                         float* __restrict__ lse, int n, int f,
                         float inv_tau) {
  fwd_wgmma<false>(A, B, out, lse, nullptr, nullptr, n, f, inv_tau);
}

// Both directions' forward: out1 and lse1 of A's rows, the diagonal, and
// the block's column sums of exp(sim - 1/tau) in row b of ws [blocks, n].
__global__ void __launch_bounds__(WG_THREADS, 1)
infonce_fwd_pair_wgmma_kernel(const float* __restrict__ A,
                              const float* __restrict__ B,
                              float* __restrict__ out1,
                              float* __restrict__ lse1,
                              float* __restrict__ diag,
                              float* __restrict__ ws, int n, int f,
                              float inv_tau) {
  fwd_wgmma<true>(A, B, out1, lse1, diag, ws, n, f, inv_tau);
}

// lse2_j = 1/tau + log(the column sums of ws, added in float64 in block
// order) and out2_j = diag_j - lse2_j: a thread a column, a warp's loads
// of one block row contiguous.
__global__ void infonce_fwd_pair_merge_kernel(const float* __restrict__ ws,
                                              const float* __restrict__ diag,
                                              float* __restrict__ out2,
                                              float* __restrict__ lse2,
                                              int blocks, int n,
                                              float inv_tau) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float* col = ws + j;
  double s = 0.0;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += (double)col[(int64_t)b * n];
  const float l = static_cast<float>((double)inv_tau + log(s));
  lse2[j] = l;
  out2[j] = diag[j] - l;
}

// ---------------------------------------------------------------------------
// dA and dB: what both gradient kernels share
// ---------------------------------------------------------------------------

// t = P[row] . r in float64 over the f features, as float32 hi + lo (0
// for row >= n). The four lanes of a quad hold the same row and split its
// features.
__device__ __forceinline__ void dot_ref(const float* __restrict__ P,
                                        const float* __restrict__ rq,
                                        int row, int n, int f, int t,
                                        float& hi, float& lo) {
  double d = 0.0;
  if (row < n) {
    const float* p = P + (int64_t)row * f;
    for (int k = t; k < f; k += 4) d += (double)p[k] * (double)rq[k];
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  hi = static_cast<float>(d);
  lo = static_cast<float>(d - (double)hi);
}

// lse_i in base 2 and g_i / tau of the anchors i of a lane's
// coefficients, 0 past n. The block's rows (COLS false: dA's, and the
// pair's owned side): the lane's two rows, read once. The tile's columns
// (COLS true: dB's, and the pair's streamed side): columns
// c0 + 8 j + 2 t + u, 2 J of them, read per tile.
template <int J, bool COLS>
struct Anchors {
  float lse2[COLS ? J : 1][2], gs[COLS ? J : 1][2];

  __device__ __forceinline__ void read(const float* __restrict__ lse,
                                       const float* __restrict__ gout, int i,
                                       int n, float inv_tau, int j, int u) {
    lse2[j][u] = i < n ? lse[i] * LOG2E : 0.f;
    gs[j][u] = i < n ? gout[i] * inv_tau : 0.f;
  }
  __device__ __forceinline__ void rows(const float* __restrict__ lse,
                                       const float* __restrict__ gout,
                                       int row, int n, float inv_tau) {
#pragma unroll
    for (int h = 0; h < 2; ++h) read(lse, gout, row + 8 * h, n, inv_tau, 0, h);
  }
  __device__ __forceinline__ void cols(const float* __restrict__ lse,
                                       const float* __restrict__ gout,
                                       int c0, int t, int n, float inv_tau) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        read(lse, gout, c0 + 8 * j + 2 * t + u, n, inv_tau, j, u);
  }
  // of the coefficient in row g + 8 (e / 2), column 8 j + 2 t + e % 2
  __device__ __forceinline__ float l2(int j, int e) const {
    return lse2[COLS ? j : 0][COLS ? (e & 1) : (e >> 1)];
  }
  __device__ __forceinline__ float gt(int j, int e) const {
    return gs[COLS ? j : 0][COLS ? (e & 1) : (e >> 1)];
  }
};

// What a gradient kernel makes: dA (the rows' anchors' terms), dB (the
// columns') or the pair's G P (both).
enum Grad { GRAD_DA, GRAD_DB, GRAD_PAIR };

// A tile's coefficients, in place of its shifted similarities: s[j][e] is
// row row0 + g + 8 (e / 2) of P, column c0 + 8 j + 2 t + e % 2 of the tile
// (8 J columns), and P_row . r = thi + tlo is added back first (see "what
// is summed"). The terms of the rows' anchors `own` (dA, the pair) and of
// the columns' `str` (dB, the pair); the lane adds the columns' terms of
// each of its rows to csum: float32 within the tile, float64 across tiles.
template <int J, int MODE>
__device__ __forceinline__ void tile_coef(float (&s)[J][4],
                                          const Anchors<J, false>& own,
                                          const Anchors<J, true>& str,
                                          const float (&thi)[2],
                                          const float (&tlo)[2], int c0,
                                          int row0, int g, int t, int n,
                                          float scale2, double (&csum)[2]) {
  constexpr bool ROWS = MODE != GRAD_DB, COLS = MODE != GRAD_DA;
  float part[2] = {0.f, 0.f};  // the pair: its columns' terms of each row
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = (s[j][e] + tlo[e >> 1]) + thi[e >> 1];
      if constexpr (MODE == GRAD_PAIR) {
        const float c = exp2f(fmaf(x, scale2, -str.l2(j, e))) * str.gt(j, e);
        part[e >> 1] -= c;
        s[j][e] = -fmaf(exp2f(fmaf(x, scale2, -own.l2(j, e))), own.gt(j, e),
                        c);
      } else if constexpr (ROWS) {
        s[j][e] = -exp2f(fmaf(x, scale2, -own.l2(j, e))) * own.gt(j, e);
      } else {
        s[j][e] = -exp2f(fmaf(x, scale2, -str.l2(j, e))) * str.gt(j, e);
      }
    }
  if (c0 < row0 + 16 && c0 + 8 * J > row0) {  // the diagonal crosses
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + 8 * j + 2 * t + (e & 1) == row0 + g + 8 * (e >> 1)) {
          if constexpr (ROWS) s[j][e] += own.gt(j, e);
          if constexpr (COLS) s[j][e] += str.gt(j, e);
          if constexpr (MODE == GRAD_PAIR) part[e >> 1] += str.gt(j, e);
        }
  }
  // rows past n have g = 0 in the rows' terms and are not written; the
  // columns' terms have g = 0 in columns past n, and the rows' terms are
  // set to 0 there
  if (ROWS && c0 + 8 * J > n) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + 8 * j + 2 * t + (e & 1) >= n) s[j][e] = 0.f;
  }
  if constexpr (MODE == GRAD_DB) {  // every term is a column's
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < J; ++j) part[h] += s[j][2 * h] + s[j][2 * h + 1];
    }
  }
  if constexpr (COLS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) csum[h] += part[h];
  }
}

// csum of the lane's rows over the four lanes of its quad.
__device__ __forceinline__ void quad_sum(double (&csum)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 1);
    csum[h] += __shfl_xor_sync(0xffffffffu, csum[h], 2);
  }
}

// dA (DB false) or dB (DB true) at other widths, on mma.sync: grad = dA or
// dB, P and Q as above, r = Q[r0] with r0 the block's first own row.
template <int WARPS, bool DB>
__global__ void __launch_bounds__(32 * WARPS, 1)
infonce_bwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ lse,
                   const float* __restrict__ gout, float* __restrict__ grad,
                   int n, int f, float inv_tau, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const float* __restrict__ P = DB ? B : A;
  const float* __restrict__ Q = DB ? A : B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * 16 * WARPS;
  const int row0 = r0 + 16 * warp;
  const int chunk = blockIdx.y, fo0 = chunk * KC;
  const int kfo = chunk_width(chunk, f);
  const float scale2 = inv_tau * LOG2E;
  const float* __restrict__ rq = Q + (int64_t)r0 * f;

  Anchors<8, false> own;  // dA's
  Anchors<8, true> str;   // dB's
  if constexpr (!DB) own.rows(lse, gout, row0 + g, n, inv_tau);
  float thi[2], tlo[2];  // P_row . r of rows row0 + g and row0 + g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
    dot_ref(P, rq, row0 + g + 8 * h, n, f, t, thi[h], tlo[h]);
  float ref[4][4];  // r at this lane's features of the second product
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = fo0 + 32 * m + 4 * g + q;
      ref[m][q] = k < f ? rq[k] : 0.f;
    }
  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  double csum[2] = {0.0, 0.0};

  for_each_tile<WARPS, true>(
      P, Q, n, f, vec, chunk, smem,
      [&](float (&s)[8][4], int c0, const float* stage) {
        if constexpr (DB) str.cols(lse, gout, c0, t, n, inv_tau);
        tile_coef<8, DB ? GRAD_DB : GRAD_DA>(s, own, str, thi, tlo, c0, row0,
                                             g, t, n, scale2, csum);
        coef_mma(acc, s, stage, ref, kfo, g, t);
      });

  if (DB) quad_sum(csum);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
    float* dst = grad + (int64_t)row * f + fo0 + 8 * t;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = 32 * m + 4 * half;  // + 8 t + q
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = acc[4 * m + q][2 * h + half];
          const int kk = fo0 + 8 * t + k + q;
          if (DB && kk < f)  // dB_j = the sum + r c_j
            v[q] = static_cast<float>(v[q] + (double)rq[kk] * csum[h]);
        }
        if (vec) {
          if (fo0 + 8 * t + k < f)
            *reinterpret_cast<float4*>(dst + k) =
                make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (fo0 + 8 * t + k + q < f) dst[k + q] = v[q];
        }
      }
  }
}

// ---------------------------------------------------------------------------
// dA and dB at f <= 128, f % 4 == 0: wgmma
// ---------------------------------------------------------------------------

constexpr int BWD_ROWS = 64;      // rows of P a block owns: one warpgroup
constexpr int BWD_THREADS = 256;  // a warpgroup that multiplies, one that feeds
constexpr int BWD_TN = 32;        // rows of Q in a tile
constexpr int BWD_RING = 4;       // stages of Q tiles
constexpr int BWD_PPANEL = BWD_ROWS * 32;  // floats in a panel of P's rows
constexpr int BWD_QPANEL = BWD_TN * 32;    // floats in a panel of a stage
constexpr int BWD_STAGE = 4 * BWD_QPANEL;  // 16 KB, also a lo or V^T plane
// P hi and lo, the ring, two lo planes, two pairs of V^T planes
constexpr int BWD_SMEM = sizeof(float) * (2 * 4 * BWD_PPANEL +
                                          (BWD_RING + 2 + 4) * BWD_STAGE) +
                         1024;

// As `swizzled`, for panels of `panel` floats.
__device__ __forceinline__ int swizzled_in(int panel, int row, int c) {
  return (c >> 3) * panel + row * 32 + (((c & 7) ^ (row & 7)) << 2);
}

// One block: rows [64 b, 64 b + 64) of P against all tiles of 32 rows of
// Q (P, Q = A, B for dA; B, A for dB), both products on wgmma, in 3xTF32,
// by two warpgroups: one issues the wgmma and does the arithmetic on their
// results (the consumer), the other copies and splits the tiles (the
// producer). The block's rows of P lie in shared memory in the swizzled
// layout, with their lo plane, for its whole life (the registers go to
// the sums). A tile of Q arrives by cp.async in the same layout; the
// producer then rewrites it in place less r (the row of Q at the block's
// first own index: see "what is summed" above), which is the hi plane of
// the similarity product, and writes its lo plane and, for the second
// product, the same values transposed, with their lo plane:
// V^T[feature][column], which is what wgmma needs of a TF32 operand that
// is summed over the tile's columns. Each producer thread takes one
// feature of every column of the tile, so no two threads touch one
// element. The similarities come out of wgmma in the accumulator layout
// (a lane has columns 2 t, 2 t + 1 of each 8), become the coefficients in
// place, and go back in as the A operand of the second product (k = t,
// t + 4): V^T is written with its columns in that order, and nothing
// moves. The second product starts from zero for every tile and is added
// to the running total with a float32 add (the two-level sum). dB and the
// pair read lse_i and g_i of a tile's columns one tile ahead (in flight
// under the second product and the next similarity product), keep c_j,
// and add r c_j in the epilogue.
//
// Per tile j, after one barrier of all 256 threads: the consumer runs the
// similarities of tile j on the tensor cores, adds tile j - 1's product to
// the total meanwhile, waits, makes the coefficients, runs the second
// product and waits for it; the producer starts the copy of tile j + 3 and
// splits tile j + 1. What the compiler needs to keep the wgmma
// asynchronous (it puts a wait behind every one otherwise, silently or
// with remark C7518): no group left open across the loop's back edge, and
// a role test that it can see is uniform in a warp.
//
// (lse_own, g_own) are the anchors of P's rows (dA, the pair), (lse_str,
// g_str) those of Q's rows (dB, the pair).
template <int MODE>
__device__ __forceinline__ void bwd_wgmma(const float* __restrict__ P,
                                          const float* __restrict__ Q,
                                          const float* __restrict__ lse_own,
                                          const float* __restrict__ g_own,
                                          const float* __restrict__ lse_str,
                                          const float* __restrict__ g_str,
                                          float* __restrict__ grad, int n,
                                          int f, float inv_tau) {
  constexpr bool ROWS = MODE != GRAD_DB, COLS = MODE != GRAD_DA;
  extern __shared__ float smem_raw[];
  float* p_hi = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* p_lo = p_hi + 4 * BWD_PPANEL;
  float* ring = p_lo + 4 * BWD_PPANEL;
  float* lo = ring + BWD_RING * BWD_STAGE;  // two lo planes
  float* vt = lo + 2 * BWD_STAGE;           // two pairs (hi, lo) of V^T planes
  // from lane 0, so that the compiler sees a branch no warp diverges on
  const bool producer = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) != 0;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * BWD_ROWS, row0 = r0 + 16 * warp;
  const int npanels = (f + 31) / 32;  // panels of 32 features
  const int chunks = 8 * npanels;     // 16-byte chunks of a row
  const int ntiles = (n + BWD_TN - 1) / BWD_TN;
  const int c = tid % 32;      // this thread's chunk of a row
  const float scale2 = inv_tau * LOG2E;
  const float* __restrict__ rq = Q + (int64_t)r0 * f;  // r

  // this thread's chunk in rows warp + 4 i of a stage: the row's low bits
  // are (warp + 4 i) & 7, so the swizzle flips one bit with i's parity
  const int off0 = swizzled_in(BWD_QPANEL, warp, c);
  const int off1 = swizzled_in(BWD_QPANEL, warp + 4, c) - 4 * 32;
  const bool c_in = 4 * c < f;
  auto load_tile = [&](int tile) {
    if (tile < ntiles && c < chunks) {
      float* stage = ring + (tile % BWD_RING) * BWD_STAGE;
      const int col0 = tile * BWD_TN + warp;
      const float* src = Q + (int64_t)col0 * f + 4 * c;
#pragma unroll
      for (int i = 0; i < BWD_TN / 4; ++i) {
        const bool in = c_in && col0 + 4 * i < n;
        cp_async16(stage + ((i & 1) ? off1 : off0) + 4 * i * 32,
                   in ? src + (int64_t)4 * i * f : Q, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  if (producer && c < chunks) {
#pragma unroll 4
    for (int row = warp; row < BWD_ROWS; row += 4) {
      const bool in = r0 + row < n && 4 * c < f;
      cp_async16(p_hi + swizzled_in(BWD_PPANEL, row, c),
                 in ? P + (int64_t)(r0 + row) * f + 4 * c : P, in ? 16 : 0);
    }
  }
  if (producer)
    for (int tile = 0; tile < BWD_RING - 1; ++tile) load_tile(tile);

  // this thread's feature of a tile, and r there
  const float ref = tid < f ? rq[tid] : 0.f;

  // a tile of Q, once it has landed: in place less r, its lo plane, and
  // its V^T planes: V^T[feature][k] with k the place of a column in the
  // second product's A operand: columns 8 s + 2 u and 8 s + 2 u + 1 sit at
  // k = 8 s + u and 8 s + u + 4. All 32 loads are issued before the first
  // store, which the compiler cannot move them past: one wait on shared
  // memory a tile, not one a column.
  auto split_tile = [&](int tile) {
    float* stage = ring + (tile % BWD_RING) * BWD_STAGE;
    float* plane = lo + (tile % 2) * BWD_STAGE;
    float* vh = vt + (tile % 2) * 2 * BWD_STAGE;
    float* vl = vh + BWD_STAGE;
    const int tbase = (tid / 32) * BWD_QPANEL + tid % 4;
    const int tx4 = ((tid / 4) & 7) << 2;
    auto at = [&](int q, int u) {  // column 8 (q / 2) + 2 u + (q & 1)
      const int col = 8 * (q / 2) + 2 * u + (q & 1);
      return tbase + col * 32 + (tx4 ^ ((col & 7) << 2));
    };
    float d[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int u = 0; u < 4; ++u) d[q][u] = stage[at(q, u)];
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // k = 4 q .. 4 q + 3
      uint32_t l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        d[q][u] = tid < f ? d[q][u] - ref : 0.f;
        l[u] = lo_of_cut(d[q][u]);
        stage[at(q, u)] = d[q][u];
        plane[at(q, u)] = __uint_as_float(l[u]);
      }
      const int off = tid * 32 + ((q ^ (tid & 7)) << 2);
      *reinterpret_cast<float4*>(vh + off) =
          make_float4(d[q][0], d[q][1], d[q][2], d[q][3]);
      *reinterpret_cast<uint4*>(vl + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  };

  cp_async_wait<BWD_RING - 2>();
  __syncthreads();  // the block's rows of P and tile 0 have landed
  if (producer && c < chunks) {
#pragma unroll 4
    for (int row = warp; row < BWD_ROWS; row += 4) {
      const int off = swizzled_in(BWD_PPANEL, row, c);
      const float4 v = *reinterpret_cast<const float4*>(p_hi + off);
      *reinterpret_cast<uint4*>(p_lo + off) = make_uint4(
          lo_of_cut(v.x), lo_of_cut(v.y), lo_of_cut(v.z), lo_of_cut(v.w));
    }
  }
  if (producer) {
    split_tile(0);
    for (int tile = 0; tile < ntiles; ++tile) {
      cp_async_wait<BWD_RING - 3>();  // this thread's copies of tile + 1
      // what this thread wrote (copies and planes) becomes visible to wgmma
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      load_tile(tile + BWD_RING - 1);
      if (tile + 1 < ntiles) split_tile(tile + 1);
    }
    cp_async_wait<0>();
    return;
  }

  Anchors<4, false> own;
  Anchors<4, true> str;
  if constexpr (ROWS) own.rows(lse_own, g_own, row0 + g, n, inv_tau);
  if constexpr (COLS)
    str.cols(lse_str, g_str, 0, t, n, inv_tau);  // then a tile ahead
  float thi[2], tlo[2];  // P_row . r of rows row0 + g and row0 + g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
    dot_ref(P, rq, row0 + g + 8 * h, n, f, t, thi[h], tlo[h]);
  double csum[2] = {0.0, 0.0};
  float acc[16][4] = {}, part[16][4] = {}, s[4][4] = {};
  for (int tile = 0; tile < ntiles; ++tile) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const float* stage = ring + (tile % BWD_RING) * BWD_STAGE;
    const float* plane = lo + (tile % 2) * BWD_STAGE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
    for (int p = 0; p < npanels; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int pa = p * BWD_PPANEL + kk * 8;
        const int pb = p * BWD_QPANEL + kk * 8;
        const uint64_t ah = wgmma_desc(p_hi + pa);
        const uint64_t al = wgmma_desc(p_lo + pa);
        const uint64_t bh = wgmma_desc(stage + pb);
        const uint64_t bl = wgmma_desc(plane + pb);
        wgmma_tf32_n32(s, al, bh, p + kk > 0);  // the small terms first
        wgmma_tf32_n32(s, ah, bl, 1);
        wgmma_tf32_n32(s, ah, bh, 1);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (tile > 0) {  // under the similarity product: the last tile's sum
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
    const int c0 = tile * BWD_TN;
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(s[j][e])::"memory");

    tile_coef<4, MODE>(s, own, str, thi, tlo, c0, row0, g, t, n, scale2,
                       csum);
    // the next tile's anchors, in flight under the second product and the
    // next similarity product
    if constexpr (COLS) str.cols(lse_str, g_str, c0 + BWD_TN, t, n, inv_tau);
    const float* vh = vt + (tile % 2) * 2 * BWD_STAGE;
    const float* vl = vh + BWD_STAGE;
    // the A operand of the second product, every k-step in registers of
    // its own: k = t is the tile's column 8 k + 2 t, k = t + 4 column
    // 8 k + 2 t + 1
    uint32_t cl[4][4], ch[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cl[k][0] = lo_of_cut(s[k][0]), cl[k][1] = lo_of_cut(s[k][2]);
      cl[k][2] = lo_of_cut(s[k][1]), cl[k][3] = lo_of_cut(s[k][3]);
      ch[k][0] = __float_as_uint(s[k][0]);
      ch[k][1] = __float_as_uint(s[k][2]);
      ch[k][2] = __float_as_uint(s[k][1]);
      ch[k][3] = __float_as_uint(s[k][3]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm volatile("" : "+r"(cl[k][i])::"memory");
        asm volatile("" : "+r"(ch[k][i])::"memory");
      }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t bh = wgmma_desc(vh + 8 * k), bl = wgmma_desc(vl + 8 * k);
      wgmma_tf32_n128(part, cl[k], bh, k > 0);  // the small terms first
      wgmma_tf32_n128(part, ch[k], bl, 1);
      wgmma_tf32_n128(part, ch[k], bh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+f"(part[j][e])::"memory");
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  if (COLS) quad_sum(csum);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = 8 * j + 2 * t;
      if (k >= f) continue;
      float2 v = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      if (COLS) {  // the sum + r c_j
        v.x = static_cast<float>(v.x + (double)rq[k] * csum[h]);
        v.y = static_cast<float>(v.y + (double)rq[k + 1] * csum[h]);
      }
      *reinterpret_cast<float2*>(grad + (int64_t)row * f + k) = v;
    }
  }
}

template <bool DB>
__global__ void __launch_bounds__(BWD_THREADS, 1)
infonce_bwd_wgmma_kernel(const float* __restrict__ A,
                         const float* __restrict__ B,
                         const float* __restrict__ lse,
                         const float* __restrict__ gout,
                         float* __restrict__ grad, int n, int f,
                         float inv_tau) {
  if constexpr (DB)
    bwd_wgmma<GRAD_DB>(B, A, nullptr, nullptr, lse, gout, grad, n, f,
                       inv_tau);
  else
    bwd_wgmma<GRAD_DA>(A, B, lse, gout, nullptr, nullptr, grad, n, f,
                       inv_tau);
}

// G P of the pair for the rows of P: dA with (P, Q) = (A, B), (lse_own,
// g_own) = (lse1, g1) and (lse_str, g_str) = (lse2, g2); dB with both
// pairs swapped.
__global__ void __launch_bounds__(BWD_THREADS, 1)
infonce_bwd_pair_wgmma_kernel(const float* __restrict__ P,
                              const float* __restrict__ Q,
                              const float* __restrict__ lse_own,
                              const float* __restrict__ g_own,
                              const float* __restrict__ lse_str,
                              const float* __restrict__ g_str,
                              float* __restrict__ grad, int n, int f,
                              float inv_tau) {
  bwd_wgmma<GRAD_PAIR>(P, Q, lse_own, g_own, lse_str, g_str, grad, n, f,
                       inv_tau);
}

// Rows a block owns, as warps of 16, for nch feature chunks: the most
// whose resident rows fit beside the ring. 0 if none does.
int warps_for(int nch) {
  return nch <= 1 ? 8 : nch <= 3 ? 4 : nch <= 7 ? 2 : nch <= MAX_CHUNKS ? 1 : 0;
}

size_t smem_bytes(int warps, int nch) {
  return sizeof(float) * ((size_t)16 * warps * nch * LD + NST * STAGE);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The widths and pointers the wgmma kernels take, and so the pair's.
bool wgmma_fits(int f, const void* a, const void* b) {
  return f <= KC && f % 4 == 0 && aligned16(a) && aligned16(b);
}

template <int WARPS>
int launch_fwd(const float* a, const float* b, float* out, float* lse, int n,
               int f, float inv_tau, cudaStream_t stream) {
  const size_t bytes = smem_bytes(WARPS, (f + KC - 1) / KC);
  const cudaError_t err = cudaFuncSetAttribute(
      infonce_fwd_kernel<WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = f % 4 == 0 && aligned16(a) && aligned16(b);
  infonce_fwd_kernel<WARPS>
      <<<(n + 16 * WARPS - 1) / (16 * WARPS), 32 * WARPS, bytes, stream>>>(
          a, b, out, lse, n, f, inv_tau, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int WARPS, bool DB>
int launch_bwd(const float* a, const float* b, const float* lse,
               const float* g, float* grad, int n, int f, float inv_tau,
               cudaStream_t stream) {
  const int nch = (f + KC - 1) / KC;
  const size_t bytes = smem_bytes(WARPS, nch);
  const cudaError_t err = cudaFuncSetAttribute(
      infonce_bwd_kernel<WARPS, DB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec =
      f % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(grad);
  infonce_bwd_kernel<WARPS, DB>
      <<<dim3((n + 16 * WARPS - 1) / (16 * WARPS), nch), 32 * WARPS, bytes,
         stream>>>(a, b, lse, g, grad, n, f, inv_tau, vec);
  return static_cast<int>(cudaGetLastError());
}

// dA (DB false) or dB (DB true): wgmma where the width and the pointers
// allow it, else mma.sync with the most rows that fit.
template <bool DB>
int launch_grad(const void* a, const void* b, const void* lse, const void* g,
                void* grad, int n, int f, float inv_tau, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pl = static_cast<const float*>(lse);
  const float* pg = static_cast<const float*>(g);
  float* pd = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f <= KC && f % 4 == 0 && aligned16(a) && aligned16(b) &&
      aligned16(grad)) {
    const cudaError_t err = cudaFuncSetAttribute(
        infonce_bwd_wgmma_kernel<DB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    infonce_bwd_wgmma_kernel<DB>
        <<<(n + BWD_ROWS - 1) / BWD_ROWS, BWD_THREADS, BWD_SMEM, st>>>(
            pa, pb, pl, pg, pd, n, f, inv_tau);
    return static_cast<int>(cudaGetLastError());
  }
  switch (warps_for((f + KC - 1) / KC)) {
    case 8: return launch_bwd<8, DB>(pa, pb, pl, pg, pd, n, f, inv_tau, st);
    case 4: return launch_bwd<4, DB>(pa, pb, pl, pg, pd, n, f, inv_tau, st);
    case 2: return launch_bwd<2, DB>(pa, pb, pl, pg, pd, n, f, inv_tau, st);
    case 1: return launch_bwd<1, DB>(pa, pb, pl, pg, pd, n, f, inv_tau, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes. Each launches on `stream`, does not
// synchronise, and returns a cudaError_t (0 on success): that of the
// shared-memory opt-in, else cudaGetLastError() after the launch.
extern "C" {

int infonce_fwd(const void* a, const void* b, void* out, void* lse, int n,
                int f, float inv_tau, void* stream) {
  if (n <= 0) return 0;
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  float* pl = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f <= KC && f % 4 == 0 && aligned16(b)) {
    const cudaError_t err = cudaFuncSetAttribute(
        infonce_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WG_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    infonce_fwd_wgmma_kernel<<<(n + 127) / 128, WG_THREADS, WG_SMEM, st>>>(
        pa, pb, po, pl, n, f, inv_tau);
    return static_cast<int>(cudaGetLastError());
  }
  switch (warps_for((f + KC - 1) / KC)) {
    case 8: return launch_fwd<8>(pa, pb, po, pl, n, f, inv_tau, st);
    case 4: return launch_fwd<4>(pa, pb, po, pl, n, f, inv_tau, st);
    case 2: return launch_fwd<2>(pa, pb, po, pl, n, f, inv_tau, st);
    case 1: return launch_fwd<1>(pa, pb, po, pl, n, f, inv_tau, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int infonce_bwd_da(const void* a, const void* b, const void* lse,
                   const void* g, void* da, int n, int f, float inv_tau,
                   void* stream) {
  return launch_grad<false>(a, b, lse, g, da, n, f, inv_tau, stream);
}

int infonce_bwd_db(const void* a, const void* b, const void* lse,
                   const void* g, void* db, int n, int f, float inv_tau,
                   void* stream) {
  return launch_grad<true>(a, b, lse, g, db, n, f, inv_tau, stream);
}

// Both directions' forward: out1, lse1 (rows of sim), out2, lse2 (its
// columns); diag [n] and ws [ceil(n / 128), n] are the caller's scratch.
// The pair runs only where the wgmma kernels do: else cudaErrorInvalidValue.
int infonce_fwd_pair(const void* a, const void* b, void* out1, void* lse1,
                     void* out2, void* lse2, void* diag, void* ws, int n,
                     int f, float inv_tau, void* stream) {
  if (n <= 0) return 0;
  if (!wgmma_fits(f, a, b)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaFuncSetAttribute(
      infonce_fwd_pair_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WG_PAIR_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + WG_ROWS - 1) / WG_ROWS;
  infonce_fwd_pair_wgmma_kernel<<<blocks, WG_THREADS, WG_PAIR_SMEM, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out1), static_cast<float*>(lse1),
      static_cast<float*>(diag), static_cast<float*>(ws), n, f, inv_tau);
  infonce_fwd_pair_merge_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(diag),
      static_cast<float*>(out2), static_cast<float*>(lse2), blocks, n,
      inv_tau);
  return static_cast<int>(cudaGetLastError());
}

// G P of the pair for the rows of P (see the kernel); the same rule.
int infonce_bwd_pair(const void* p, const void* q, const void* lse_own,
                     const void* g_own, const void* lse_str,
                     const void* g_str, void* grad, int n, int f,
                     float inv_tau, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  if (!wgmma_fits(f, p, q) || !aligned16(grad))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      infonce_bwd_pair_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  infonce_bwd_pair_wgmma_kernel<<<(n + BWD_ROWS - 1) / BWD_ROWS, BWD_THREADS,
                                  BWD_SMEM,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q),
      static_cast<const float*>(lse_own), static_cast<const float*>(g_own),
      static_cast<const float*>(lse_str), static_cast<const float*>(g_str),
      static_cast<float*>(grad), n, f, inv_tau);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
