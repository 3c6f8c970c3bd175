// What one SM of the card does with the instruction mix of a 3xTF32 kernel
// built on mma.sync: a stand-alone measurement, not part of the port's
// path. Five loops, each run by 8 warps a block on every SM, report clocks
// per iteration and SM:
//   mma          64 mma.sync.m16n8k8 TF32 a warp, 8 independent accumulators
//   lds          16 128-bit shared-memory loads a warp (conflict-free)
//   split        64 Veltkamp splits a warp (4 float32 operations each)
//   mma + lds    the loads feed the B operands of the mma
//   mma + split  each B operand goes through a split first
// If two kinds of work overlap, the combined loop takes about the longer
// of the two; if not, about their sum. It also prints the mma rate in
// TFLOP/s. Build and run: rlap_tpu_torch/bench/probe_mma.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int LD = 132;  // the kernels' shared-memory row stride, floats
constexpr int SMEM = 192 * LD * sizeof(float);

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float4 lds128(const float* p) {
  float4 v;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// hi of Veltkamp's split of x at TF32's precision; lo = x - hi
__device__ __forceinline__ float split_hi(float x) {
  const float c = __fmul_rn(x, 8193.f);
  return __fsub_rn(c, __fsub_rn(c, x));
}

template <bool MMA, bool LDS, bool SPLIT>
__global__ void __launch_bounds__(256, 1) mix(float* out, int iters) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < 192 * LD; i += 256) sm[i] = 1e-3f * (i % 97);
  __syncthreads();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* base = sm + g * LD + 8 * t;  // the kernels' fragment pattern
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, 3, 4};
  float sink = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float* p = base + (it & 3) * 32;
    float v[8][8];  // [n-tile][feature]
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (LDS) {
        const float4 v0 = lds128(p + nt * 8 * LD);
        const float4 v1 = lds128(p + nt * 8 * LD + 4);
        v[nt][0] = v0.x, v[nt][1] = v0.y, v[nt][2] = v0.z, v[nt][3] = v0.w;
        v[nt][4] = v1.x, v[nt][5] = v1.y, v[nt][6] = v1.z, v[nt][7] = v1.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[nt][i] = __int_as_float(it + i + nt);
      }
    }
    // the 8 accumulators take turns, so no mma waits for the one before
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float b0 = v[nt][i], b1 = v[nt][i + 1], l0 = 0.f, l1 = 0.f;
        if (SPLIT) {
          b0 = split_hi(v[nt][i]), b1 = split_hi(v[nt][i + 1]);
          l0 = v[nt][i] - b0, l1 = v[nt][i + 1] - b1;
        }
        if (MMA) {
          mma_tf32(acc[nt], a, __float_as_uint(b0), __float_as_uint(b1));
          if (SPLIT) acc[nt][0] += 0.f * (l0 + l1);  // keeps the lo parts
        } else {
          sink += b0 + b1 + l0 + l1;
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        if (MMA)
          mma_tf32(acc[nt], a, __float_as_uint(v[nt][i + 1]),
                   __float_as_uint(v[nt][i]));
    }
  }
  for (int i = 0; i < 8; ++i)
    for (int e = 0; e < 4; ++e) sink += acc[i][e];
  out[blockIdx.x * 256 + threadIdx.x] = sink;
}

template <bool MMA, bool LDS, bool SPLIT>
double run(const char* name, float* out, int sms, double ghz) {
  cudaFuncSetAttribute(mix<MMA, LDS, SPLIT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  const int iters = 20000;
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  mix<MMA, LDS, SPLIT><<<sms, 256, SMEM>>>(out, 10);
  cudaEventRecord(s);
  mix<MMA, LDS, SPLIT><<<sms, 256, SMEM>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, s, e);
  const double clk = ms * 1e-3 * ghz * 1e9 / iters;
  printf("{\"loop\": \"%s\", \"ms\": %.4f, \"clocks_per_iteration\": %.1f",
         name, ms, clk);
  if (MMA)  // 8 warps x 64 mma x 2048 FLOP an iteration and SM
    printf(", \"mma_tflops\": %.1f",
           8.0 * 64 * 2048 * iters * sms / (ms * 1e-3) / 1e12);
  printf(", \"cuda_error\": %d}\n", (int)cudaGetLastError());
  return clk;
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const double ghz = khz * 1e-6;
  printf("{\"device\": \"%s\", \"sms\": %d, \"clock_ghz\": %.3f}\n", prop.name,
         prop.multiProcessorCount, ghz);
  float* out;
  cudaMalloc(&out, prop.multiProcessorCount * 256 * sizeof(float));
  const int sms = prop.multiProcessorCount;
  run<true, false, false>("mma", out, sms, ghz);
  run<false, true, false>("lds", out, sms, ghz);
  run<false, false, true>("split", out, sms, ghz);
  run<true, true, false>("mma + lds", out, sms, ghz);
  run<true, false, true>("mma + split", out, sms, ghz);
  cudaFree(out);
  return 0;
}
