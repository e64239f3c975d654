// Softmax cross-entropy forward for Hopper (sm_90a), bound to PyTorch
// through ctypes by dlrover_tpu_torch/ops/cross_entropy.py.
//
// Replaces the Pallas TPU kernel dlrover_tpu/ops/cross_entropy.py:_kernel
// (reached through _pallas_loss): for each row of [rows, V] logits,
//     loss = (m + log(sum(exp(x - m)))) - x[label],   m = max(x)
// in fp32, the target picked by an index compare (a label outside [0, V)
// picks nothing, so its target is 0), written as fp32 [rows].
//
// What bounds it: bytes.  Each logit is read once for a handful of flops
// (a compare, a subtract, an exp, an add): at [8192, 32000] fp32 the
// kernel must read 1.05 GB, ~313 us at 3.35 TB/s, while its ~1e9 flops
// take ~16 us at 67 TFLOP/s.
//
// Design: one block of 256 threads per row, so a row's reductions stay in
// one SM with no second kernel or atomics.  Threads read 16-byte vectors
// (4 fp32 or 8 bf16) when V and the pointer allow it, else single
// elements.  Pass 1 takes the row max; pass 2 re-reads the row (a 32000-
// wide fp32 row is 128 KB, so with ~2 rows per SM in flight it is still
// in L2) for the sum of exp(x - m) and the target.  Two passes keep the
// reference's arithmetic exactly: one max, then exponentials shifted by
// it; a one-pass online softmax would rescale partial sums and round
// differently.  Reductions are warp shuffles, then one shared-memory step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max; every thread receives it.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[NT / 32];
  __shared__ float total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < NT / 32 ? part[lane] : -INFINITY;
    t = warp_max(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

// Block-wide sums of two values; every thread receives them.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[NT / 32];
  __shared__ float2 total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) part[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < NT / 32 ? part[lane] : make_float2(0.f, 0.f);
    t.x = warp_sum(t.x);
    t.y = warp_sum(t.y);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    xent_fwd_kernel(const T* __restrict__ logits, const void* labels,
                    int label64, float* __restrict__ loss, int V) {
  using Vt = Vec<T, VEC>;
  const long long row = blockIdx.x;
  const Vt* x = reinterpret_cast<const Vt*>(logits + row * V);
  const long long label =
      label64 ? static_cast<const long long*>(labels)[row]
              : static_cast<long long>(static_cast<const int*>(labels)[row]);
  const int nvec = V / VEC;

  float mx = -INFINITY;
  for (int i = threadIdx.x; i < nvec; i += NT) {
    const Vt a = x[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) mx = fmaxf(mx, to_float(a.v[j]));
  }
  mx = block_max(mx);

  float sum = 0.f, target = 0.f;
  for (int i = threadIdx.x; i < nvec; i += NT) {
    const Vt a = x[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_float(a.v[j]);
      sum += expf(f - mx);
      if (static_cast<long long>(i) * VEC + j == label) target += f;
    }
  }
  const float2 st = block_sum2(sum, target);
  if (threadIdx.x == 0) loss[row] = (mx + logf(st.x)) - st.y;
}

template <typename T, int VEC>
void launch(const void* logits, const void* labels, int label64, float* loss,
            long long rows, int V, cudaStream_t stream) {
  xent_fwd_kernel<T, VEC><<<static_cast<unsigned>(rows), NT, 0, stream>>>(
      static_cast<const T*>(logits), labels, label64, loss, V);
}

}  // namespace

// logits: contiguous [rows, V] of dtype (0 = fp32, 1 = bf16); labels:
// [rows] int32 (label64 = 0) or int64 (label64 = 1); loss: fp32 [rows].
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int dlr_xent_fwd(const void* logits, const void* labels,
                            void* loss, long long rows, int V, int dtype,
                            int label64, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || V <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(loss);
  const bool aligned = reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  if (dtype == 1) {
    if (aligned && V % 8 == 0) {
      launch<__nv_bfloat16, 8>(logits, labels, label64, out, rows, V, s);
    } else {
      launch<__nv_bfloat16, 1>(logits, labels, label64, out, rows, V, s);
    }
  } else if (dtype == 0) {
    if (aligned && V % 4 == 0) {
      launch<float, 4>(logits, labels, label64, out, rows, V, s);
    } else {
      launch<float, 1>(logits, labels, label64, out, rows, V, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
