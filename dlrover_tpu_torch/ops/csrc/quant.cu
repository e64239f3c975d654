// Blockwise int8 quantize for Hopper (sm_90a), bound to PyTorch through
// ctypes by dlrover_tpu_torch/ops/quant.py.
//
// Replaces the Pallas TPU kernel dlrover_tpu/ops/quant.py:_quant_kernel
// (reached through _quantize_pallas from quantize_blockwise): the flat
// input, zero-padded to whole blocks of 128, gives per block
//     scale = max(max|x| * fp32(1/127), 1e-12)
//     codes = clip(rint(x / scale), -127, 127)        (int8, half-to-even)
// computed in fp32.  The reference writes max|x| / 127; XLA's algebraic
// simplifier turns a division by a constant into a product with its fp32
// reciprocal, and that is what the reference computes (jnp path and Pallas
// kernel alike).  A true division there gives a scale one ulp apart in
// some blocks and moves codes that sit on a .5 tie.
//
// What bounds it: bytes.  Each element is read once (4 bytes fp32, 2 bf16)
// and written once as a 1-byte code, for a handful of flops; a scale of 4
// bytes per 128 elements.  At 4 Mi fp32 values that is 21.1 MB, 6.3 us at
// 3.35 TB/s.
//
// Design: one warp per block of 128, four consecutive elements a lane.
// A lane makes one 16-byte load (fp32) or one 8-byte load (bf16, widened to
// fp32 in registers, which is exact) when the block lies whole inside the
// input and the pointer is aligned, else masked scalar loads.  Lanes past
// the input's end read zeros, so no padded copy is made: padded zeros add
// nothing to the maximum and get code 0, as in the reference.  A butterfly
// of shuffles gives every lane the block maximum.  The quotient x / scale
// is a true IEEE division (the file is built without --use_fast_math), as
// in XLA, not a product with the reciprocal, which rounds differently;
// rintf rounds half to even as jnp.round and torch.round do.  Each lane
// writes its four codes with one 32-bit store and lane 0 the scale.  There
// is no reduction across warps, so no shared memory and no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarpsPerCta = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

__device__ __forceinline__ int8_t to_code(float x, float scale) {
  float c = rintf(x / scale);
  c = fminf(fmaxf(c, -127.0f), 127.0f);
  return static_cast<int8_t>(c);
}

template <typename T, bool VEC>
__global__ void quant_kernel(const T* __restrict__ x,
                             int8_t* __restrict__ codes,
                             float* __restrict__ scale, long long n,
                             long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const long long base = row * kBlock + lane * 4;

  float v[4];
  if (VEC && base + 4 <= n) {
    load4(x + base, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = base + j < n ? to_float(x[base + j]) : 0.0f;
    }
  }

  float amax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                     fmaxf(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float s = fmaxf(amax * (1.0f / 127.0f), 1e-12f);

  char4 out;
  out.x = to_code(v[0], s);
  out.y = to_code(v[1], s);
  out.z = to_code(v[2], s);
  out.w = to_code(v[3], s);
  *reinterpret_cast<char4*>(codes + row * kBlock + lane * 4) = out;
  if (lane == 0) scale[row] = s;
}

template <typename T, bool VEC>
void launch(const void* x, void* codes, void* scale, long long n,
            long long rows, cudaStream_t stream) {
  const long long ctas = (rows + kWarpsPerCta - 1) / kWarpsPerCta;
  quant_kernel<T, VEC><<<static_cast<unsigned>(ctas), kWarpsPerCta * 32, 0,
                         stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(codes),
      static_cast<float*>(scale), n, rows);
}

}  // namespace

// x: contiguous flat input of n elements, dtype 0 = fp32, 1 = bf16;
// codes: int8 [ceil(n / 128), 128]; scale: fp32 [ceil(n / 128)]; all on CUDA
// device `device`.  Each pointer, n and the stream arrive as two 32-bit
// halves (launch.cuh).  Launches on `stream` with `device` current and
// returns cudaGetLastError() (0 on success).
extern "C" int dlr_quant_blockwise(uint32_t x_lo, uint32_t x_hi,
                                   uint32_t codes_lo, uint32_t codes_hi,
                                   uint32_t scale_lo, uint32_t scale_hi,
                                   uint32_t n_lo, uint32_t n_hi, int dtype,
                                   int device, uint32_t stream_lo,
                                   uint32_t stream_hi) {
  const void* x = dlr::join_ptr<const void>(x_lo, x_hi);
  void* codes = dlr::join_ptr<void>(codes_lo, codes_hi);
  void* scale = dlr::join_ptr<void>(scale_lo, scale_hi);
  const long long n = static_cast<long long>(dlr::join(n_lo, n_hi));
  if (n <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = (n + kBlock - 1) / kBlock;
  if ((rows + kWarpsPerCta - 1) / kWarpsPerCta > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(codes) % 4) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = dlr::join_ptr<CUstream_st>(stream_lo, stream_hi);
  dlr::DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (dtype == 0) {
    if (addr % 16 == 0) {
      launch<float, true>(x, codes, scale, n, rows, s);
    } else {
      launch<float, false>(x, codes, scale, n, rows, s);
    }
  } else {
    if (addr % 8 == 0) {
      launch<__nv_bfloat16, true>(x, codes, scale, n, rows, s);
    } else {
      launch<__nv_bfloat16, false>(x, codes, scale, n, rows, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
