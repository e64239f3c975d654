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
// Two routes, chosen by the wrapper from the row's shape:
//
// xent_cluster_kernel, for rows that fit kMaxCluster CTAs' shared memory
// (V * element size <= 8 * kSliceBytes: V <= 65536 fp32, 131072 bf16).  A
// thread-block cluster owns one row, and each of its CTAs a slice of it.
// The cluster has as few CTAs (1, 2, 4 or 8) as hold the row in slices of
// at most kSliceBytes = 32 KB: 4 at V 32000 fp32, 2 in bf16, 1 at V 256.
// Each CTA copies its slice from device memory into shared memory once
// (16-byte vectors when V and the pointer allow it, else single elements),
// taking the slice's max on the way.  It pushes that max into every CTA's
// shared memory (distributed shared memory, remote stores: no CTA waits on
// a remote load), so after one cluster barrier each CTA holds every max.
// Each CTA then sums exp(x - m) over its slice from shared memory and
// pushes the sum, and the target if the label's column is in its slice, to
// rank 0, which after a second barrier adds them in rank order and writes
// the loss.  So each logit is read from device memory once, and the
// arithmetic is still the reference's: one max, then exponentials shifted
// by it (an online softmax would also read once, but rescales its partial
// sums and rounds differently).  Every sum is taken in a fixed order
// (threads, warps, ranks), so a repeat is bit-identical.
//
// Why these sizes: what a CTA costs beyond its bytes (its launch, two
// cluster barriers, the block reductions) is paid once a slice, so a slice
// is made as large as still lets 7 CTAs share an SM's 227 KB, and the bf16
// kernel takes the max of bf16 pairs (vec_max) to keep its registers low
// enough for 7 CTAs an SM too.  Remote loads of the partial results (a warp
// of every CTA reading every rank) cost more than loading the row did, so
// the partial results are pushed instead.
//
// xent_fwd_kernel, for wider rows: one block of 256 threads a row.  Pass 1
// takes the row max; pass 2 re-reads the row (from L2 when it is still
// there) for the sum of exp(x - m) and the target.
//
// Reductions are warp shuffles, then one shared-memory step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int kMaxCluster = 8;          // CTAs a row, at most
constexpr int kSliceBytes = 32 * 1024;  // dynamic shared memory a CTA

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The max of a vector.  Eight bf16 values are compared as bf16 pairs (max
// is exact in any format) and only the result is widened: widening all
// eight first takes more registers than 7 CTAs an SM leave a thread.
template <typename T, int VEC>
__device__ __forceinline__ float vec_max(const Vec<T, VEC>& a) {
  float m = to_float(a.v[0]);
#pragma unroll
  for (int j = 1; j < VEC; ++j) m = fmaxf(m, to_float(a.v[j]));
  return m;
}
__device__ __forceinline__ float vec_max(const Vec<__nv_bfloat16, 8>& a) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(a.v);
  const __nv_bfloat162 m = __hmax2(__hmax2(p[0], p[1]), __hmax2(p[2], p[3]));
  return fmaxf(__low2float(m), __high2float(m));
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

// The cluster barrier in two halves (PTX barrier.cluster): arrive marks
// this CTA as started without waiting; wait returns once every CTA of the
// cluster has arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    xent_cluster_kernel(const T* __restrict__ logits, const void* labels,
                        int label64, float* __restrict__ loss, int V) {
  using Vt = Vec<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  // Rank r's partial results at [r]: the maxima in every CTA, the sums and
  // targets in rank 0's.  Each CTA pushes its own with remote stores.
  __shared__ float maxes[kMaxCluster], sums[kMaxCluster],
      targets[kMaxCluster];
  Vt* slice = reinterpret_cast<Vt*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long row = blockIdx.x / csize;
  const int nvec = V / VEC;
  const int per = (nvec + csize - 1) / csize;
  const int begin = rank * per;
  const int count = max(0, min(per, nvec - begin));
  const Vt* src = reinterpret_cast<const Vt*>(logits + row * V) + begin;

  // The one read from device memory: the slice into shared memory, and its
  // max.  Four loads a thread are issued before their values are used.
  float mx = -INFINITY;
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < count; i0 += 4 * NT) {
    Vt a[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT;
      if (i < count) a[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT;
      if (i < count) {
        slice[i] = a[u];
        mx = fmaxf(mx, vec_max(a[u]));
      }
    }
  }
  mx = block_max(mx);  // its barriers also publish the slice to the block

  // Every CTA of the cluster has started: its shared memory may be written.
  cluster_wait();
  if (threadIdx.x < csize) {
    *cluster.map_shared_rank(&maxes[rank], threadIdx.x) = mx;
  }
  cluster.sync();
  float m = maxes[0];
  for (int r = 1; r < csize; ++r) m = fmaxf(m, maxes[r]);

  float sum = 0.f;
#pragma unroll 1
  for (int i = threadIdx.x; i < count; i += NT) {
    const Vt a = slice[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum += expf(to_float(a.v[j]) - m);
  }
  sum = block_sum2(sum, 0.f).x;
  if (threadIdx.x == 0) {
    const long long label =
        label64 ? static_cast<const long long*>(labels)[row]
                : static_cast<long long>(static_cast<const int*>(labels)[row]);
    const long long off = label - static_cast<long long>(begin) * VEC;
    const float target =
        off >= 0 && off < static_cast<long long>(count) * VEC
            ? to_float(reinterpret_cast<const T*>(smem)[off])
            : 0.f;
    *cluster.map_shared_rank(&sums[rank], 0) = sum;
    *cluster.map_shared_rank(&targets[rank], 0) = target;
  }
  // After this barrier no CTA touches another's shared memory, so the
  // others may exit while rank 0 finishes.
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float s = 0.f, t = 0.f;
    for (int r = 0; r < csize; ++r) {
      s += sums[r];
      t += targets[r];
    }
    loss[row] = (m + logf(s)) - t;
  }
}

template <typename T, int VEC>
cudaError_t launch_two_pass(const void* logits, const void* labels,
                            int label64, float* loss, int rows, int V,
                            cudaStream_t stream) {
  xent_fwd_kernel<T, VEC><<<static_cast<unsigned>(rows), NT, 0, stream>>>(
      static_cast<const T*>(logits), labels, label64, loss, V);
  return cudaGetLastError();
}

// The cluster route: as few CTAs a row (1, 2, 4 or 8) as hold the row in
// slices of at most kSliceBytes.
template <typename T, int VEC>
cudaError_t launch_cluster(const void* logits, const void* labels,
                           int label64, float* loss, int rows, int V,
                           cudaStream_t stream) {
  const int nvec = V / VEC;
  int csize = 1;
  while (csize < kMaxCluster &&
         static_cast<size_t>((nvec + csize - 1) / csize) * sizeof(Vec<T, VEC>) >
             kSliceBytes) {
    csize *= 2;
  }
  const size_t smem =
      static_cast<size_t>((nvec + csize - 1) / csize) * sizeof(Vec<T, VEC>);
  if (smem > kSliceBytes ||
      static_cast<long long>(rows) * csize > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * csize);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, xent_cluster_kernel<T, VEC>,
                                       static_cast<const T*>(logits), labels,
                                       label64, loss, V);
  // A refused launch also sets the thread's last error; read it once.
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, int VEC>
cudaError_t launch(int route, const void* logits, const void* labels,
                   int label64, float* loss, int rows, int V,
                   cudaStream_t stream) {
  return route == 0
             ? launch_cluster<T, VEC>(logits, labels, label64, loss, rows, V,
                                      stream)
             : launch_two_pass<T, VEC>(logits, labels, label64, loss, rows, V,
                                       stream);
}

}  // namespace

// logits: contiguous [rows, V] of dtype (0 = fp32, 1 = bf16); labels:
// [rows] int32 (label64 = 0) or int64 (label64 = 1); loss: fp32 [rows]; all
// on CUDA device `device`.  route 0 launches xent_cluster_kernel, 1
// xent_fwd_kernel.  Each pointer and the stream arrive as two 32-bit halves
// (launch.cuh).  Launches on `stream` with `device` current and returns
// the launch's CUDA error (0 on success).
extern "C" int dlr_xent_fwd(uint32_t logits_lo, uint32_t logits_hi,
                            uint32_t labels_lo, uint32_t labels_hi,
                            uint32_t loss_lo, uint32_t loss_hi, int rows,
                            int V, int dtype, int label64, int route,
                            int device, uint32_t stream_lo,
                            uint32_t stream_hi) {
  if (rows <= 0 || V <= 0 || (dtype != 0 && dtype != 1) ||
      (route != 0 && route != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* logits = dlr::join_ptr<const void>(logits_lo, logits_hi);
  const void* labels = dlr::join_ptr<const void>(labels_lo, labels_hi);
  float* out = dlr::join_ptr<float>(loss_lo, loss_hi);
  cudaStream_t s = dlr::join_ptr<CUstream_st>(stream_lo, stream_hi);
  dlr::DeviceScope scope(device);
  if (scope.status() != cudaSuccess) return static_cast<int>(scope.status());
  const bool aligned = reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  cudaError_t err;
  if (dtype == 1) {
    err = aligned && V % 8 == 0
              ? launch<__nv_bfloat16, 8>(route, logits, labels, label64, out,
                                         rows, V, s)
              : launch<__nv_bfloat16, 1>(route, logits, labels, label64, out,
                                         rows, V, s);
  } else {
    err = aligned && V % 4 == 0
              ? launch<float, 4>(route, logits, labels, label64, out, rows, V,
                                 s)
              : launch<float, 1>(route, logits, labels, label64, out, rows, V,
                                 s);
  }
  return static_cast<int>(err);
}
