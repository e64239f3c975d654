// RMSNorm forward for Hopper (sm_90a), bound to PyTorch through ctypes by
// dlrover_tpu_torch/ops/rmsnorm.py.
//
// Replaces the Pallas TPU kernel dlrover_tpu/ops/rmsnorm.py:_kernel (reached
// through _pallas_fwd): over the last dim of a [rows, D] array,
//     out = x * rsqrt(mean(x^2) + eps) * w
// computed in fp32 and rounded once to x's type; w is the fp32 [D] gain.
//
// What bounds it: bytes.  Each element is read once and written once for
// about four flops, far below the card's ~295 flop/byte ridge.  At the
// decode shape of Llama-2-7B (8 rows of 4096 bf16) one call moves ~147 KB,
// ~0.04 us at 3.35 TB/s, so the launch itself costs more than the work; the
// levers for that (several norms per launch, fusion with the residual add,
// a CUDA graph over the decode step) belong to later work.
//
// Design: one block per row.  The TPU kernel walked row blocks in order on
// one core; here rows run in parallel on the SMs, and keeping a whole row
// in one block keeps its reduction inside the SM, with no second kernel or
// atomics.  Threads read 16-byte vectors (8 bf16 or 4 fp32) when D and the
// pointers allow it, else single elements.  Each thread sums its squares
// in fp32; the block reduces with warp shuffles, then across warps through
// shared memory.  A second pass re-reads the row, now in L1, and writes the
// scaled output with one round-to-nearest-even cast, as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; every thread receives the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float p = lane < nwarps ? partial[lane] : 0.f;
    p = warp_sum(p);
    if (lane == 0) total = p;
  }
  __syncthreads();
  return total;
}

// VEC gain values; 16-byte loads when VEC is a multiple of 4.
template <int VEC>
__device__ __forceinline__ void load_gain(const float* p, float (&g)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + j);
      g[j] = t.x;
      g[j + 1] = t.y;
      g[j + 2] = t.z;
      g[j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) g[j] = p[j];
  }
}

template <typename T, int VEC>
__global__ void rmsnorm_fwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ w,
                                   T* __restrict__ out, int D, float eps) {
  using V = Vec<T, VEC>;
  const int64_t row = blockIdx.x;
  const V* xr = reinterpret_cast<const V*>(x + row * D);
  V* orow = reinterpret_cast<V*>(out + row * D);
  const int nvec = D / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const V a = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_float(a.v[j]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss) / static_cast<float>(D) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const V a = xr[i];
    float g[VEC];
    load_gain<VEC>(w + i * VEC, g);
    V o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      from_float(to_float(a.v[j]) * inv * g[j], &o.v[j]);
    }
    orow[i] = o;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* w, void* out, long long rows, int D,
            float eps, cudaStream_t stream) {
  const int nvec = D / VEC;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rmsnorm_fwd_kernel<T, VEC><<<static_cast<unsigned>(rows), threads, 0,
                               stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), D, eps);
}

}  // namespace

// x, out: contiguous [rows, D] of dtype (0 = fp32, 1 = bf16); w: fp32 [D];
// all on CUDA device `device`.  Each pointer and the stream arrive as two
// 32-bit halves (launch.cuh).  Launches on `stream` with `device` current
// and returns cudaGetLastError() (0 on success).
extern "C" int dlr_rmsnorm_fwd(uint32_t x_lo, uint32_t x_hi, uint32_t w_lo,
                               uint32_t w_hi, uint32_t out_lo,
                               uint32_t out_hi, int rows, int D, float eps,
                               int dtype, int device, uint32_t stream_lo,
                               uint32_t stream_hi) {
  if (rows <= 0 || D <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* x = dlr::join_ptr<const void>(x_lo, x_hi);
  const void* w = dlr::join_ptr<const void>(w_lo, w_hi);
  void* out = dlr::join_ptr<void>(out_lo, out_hi);
  cudaStream_t s = dlr::join_ptr<CUstream_st>(stream_lo, stream_hi);
  dlr::DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  const bool aligned = (addr % 16) == 0;
  if (dtype == 1) {
    if (aligned && D % 8 == 0) {
      launch<__nv_bfloat16, 8>(x, w, out, rows, D, eps, s);
    } else {
      launch<__nv_bfloat16, 1>(x, w, out, rows, D, eps, s);
    }
  } else {
    if (aligned && D % 4 == 0) {
      launch<float, 4>(x, w, out, rows, D, eps, s);
    } else {
      launch<float, 1>(x, w, out, rows, D, eps, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
