// Flash attention for Hopper (sm_90a): the forward, dq and dk/dv kernels,
// bound to PyTorch through ctypes by dlrover_tpu_torch/ops/flash_attention.py.
//
// Replaces the Pallas TPU kernels of dlrover_tpu/ops/flash_attention.py:
//   fwd_kernel  <- _fwd_kernel      (reached through _flash_fwd)
//   dq_kernel   <- _bwd_dq_kernel   (reached through _flash_bwd_pallas)
//   dkv_kernel  <- _bwd_dkv_kernel  (reached through _flash_bwd_pallas)
// with the same arithmetic: q scaled by 1/sqrt(D) in fp32 before the QK^T
// product in the forward and the scale applied after the product in the
// backward; every mask the finite NEG_INF = -1e30; l floored at 1e-30 and
// lse = m + log(l); p = exp(s - lse) recomputed in the backward; P kept in
// fp32 for the PV, dV and dK products; dq written once in q's dtype; dk/dv
// summed in fp32 over the query heads of one KV head and cast once.
//
// What bounds it: operations.  At the Llama-800M training shape (B 4, H 16,
// S 2048, D 96, causal) the forward does 2 products over the S(S+1)/2
// visible pairs of each head, ~51.5 GFLOP, against ~100 MB of q, k, v and
// out: ~52 us at the bf16 tensor-core peak (989 TFLOP/s), far above the
// memory bound (~30 us at 3.35 TB/s); dq does 3 products (~78 us) and dk/dv
// 4 (~104 us).  This first version computes in fp32 on the CUDA cores
// (peak 67 TFLOP/s), as the reference does, so P is never rounded to bf16;
// it cannot come near the bf16 bound.  A tensor-core version (wgmma with P
// in bf16) changes the numbers and is later work with its own tolerance.
//
// Design: one block of 256 threads per (64-row tile, batch*head) for the
// forward and dq (grid x walks the tiles last-first, so the longest causal
// rows start first), and per (64-key tile, batch*KV head) for dk/dv, which
// loops over the GQA group's query heads inside the block and so sums dk
// and dv in registers without atomics (the result does not depend on the
// order blocks run in).  Tiles of q, k, v and g stream through shared
// memory as fp32; k, v (forward, dq) or q, g (dk/dv) are stored transposed
// with a row pitch of 65 floats, so both the tile product (consecutive
// columns per thread) and the accumulation (consecutive head-dim entries
// per thread, stride 65) read shared memory without bank conflicts.  Each
// thread owns a 4x4 micro-tile of the 64x64 score block and a 4 x D/16
// slice of the output; a row's 64 scores live in one half-warp, so its max
// and sum are half-warp shuffles.  Causal blocks beyond the diagonal and,
// with a window, blocks below it are skipped as the reference skips them.
// GQA reads KV head (h / (H/KV)) in place.  A ragged S is masked inside
// the kernels (loads past S read zero; keys and, in dk/dv, queries past S
// are masked), never padded by copies.  Any head dim D <= 128 that is a
// multiple of 8 is taken (D = 96 at 800M is not a power of two).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // query rows per tile
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads per block: 16 row groups x 16 columns
constexpr int LDT = 65;    // pitch of the transposed [D][64] tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Element strides of one [B, H, S, D] operand; the D stride is 1.
struct Str {
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* o;
  void* dq;
  void* dk;
  void* dv;
  float* lse;          // [B*H, S]: written by the forward, read by dq/dkv
  const float* delta;  // [B*H, S]
  const int* seg;      // [B, S] or null
  Str sq, sk, sv, sg, so, sdq, sdk, sdv;
  int B, H, KV, S, D, causal, window;
  float scale;
};

// Max and sum over the 16 lanes of a half-warp (offsets below 16 never
// cross into the other half).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(const Params& p, int qp, int kp,
                                        int seg_q, int seg_k) {
  bool ok = kp < p.S;
  if (p.causal) ok = ok && qp >= kp;
  if (p.window > 0) ok = ok && (qp - kp) < p.window;
  if (p.seg != nullptr) ok = ok && seg_q == seg_k;
  return ok;
}

// Key tiles [k0, k1) a query tile starting at q_start must visit.
__device__ __forceinline__ void key_tiles(const Params& p, int q_start,
                                          int* k0, int* k1) {
  int hi = (p.S + BK - 1) / BK;
  if (p.causal) hi = min(hi, (q_start + BQ - 1) / BK + 1);
  int lo = 0;
  if (p.window > 0) {
    const int first = q_start - p.window + 1;
    lo = first > 0 ? first / BK : 0;
  }
  *k0 = lo;
  *k1 = hi;
}

// Row-major [rows][D] tile of a [S, D] slice at row0 into dst with pitch
// ld; rows past S read zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int row0,
                                          int S, int D, float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i - r * D, pos = row0 + r;
    dst[r * ld + d] = pos < S ? to_float(src[pos * stride + d]) * mul : 0.f;
  }
}

// Transposed [D][64] tile (pitch LDT) of a [S, D] slice at row0.
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, const T* src,
                                          long long stride, int row0, int S,
                                          int D) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i - r * D, pos = row0 + r;
    dst[d * LDT + r] = pos < S ? to_float(src[pos * stride + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <typename T, int NJ>
__global__ void __launch_bounds__(NT) fwd_kernel(Params p) {
  extern __shared__ float sm[];
  const int D = p.D, S = p.S, ldq = D + 1;
  float* Qs = sm;                  // [BQ][D+1], q * scale
  float* KT = Qs + BQ * ldq;       // [D][LDT]
  float* Vs = KT + D * LDT;        // [BK][D]
  float* Ps = Vs + BK * D;         // [BQ][LDT]
  int* segk = reinterpret_cast<int*>(Ps + BQ * LDT);  // [BK]

  const int nq = (S + BQ - 1) / BQ;
  const int q_start = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  const int* seg = p.seg != nullptr ? p.seg + static_cast<long long>(b) * S
                                    : nullptr;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows(Qs, ldq, q, p.sq.s, q_start, S, D, p.scale);
  int segq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty * 4 + i;
    segq[i] = (seg != nullptr && qp < S) ? seg[qp] : -1;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int k0, k1;
  key_tiles(p, q_start, &k0, &k1);
  for (int kb = k0; kb < k1; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    load_cols(KT, k, p.sk.s, k_start, S, D);
    load_rows(Vs, D, v, p.sv.s, k_start, S, D, 1.f);
    if (tid < BK) {
      const int kp = k_start + tid;
      segk[tid] = (seg != nullptr && kp < S) ? seg[kp] : -1;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = KT[d * LDT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qp = q_start + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (!visible(p, qp, k_start + c, segq[i], segk[c])) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[r * LDT + tx + 16 * j] = e;
        ps += e;
      }
      ps = half_sum(ps);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row's P is written and read by one half-warp

    for (int c = 0; c < BK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * LDT + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty * 4 + i;
    if (qp < S) {
      const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) store(&o[qp * p.so.s + d], acc[i][j] / ls);
      }
      if (tx == 0) p.lse[static_cast<long long>(bh) * S + qp] = m[i] + logf(ls);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dq
// ---------------------------------------------------------------------------

template <typename T, int NJ>
__global__ void __launch_bounds__(NT) dq_kernel(Params p) {
  extern __shared__ float sm[];
  const int D = p.D, S = p.S, ldq = D + 1;
  float* Qs = sm;                  // [BQ][D+1]
  float* Gs = Qs + BQ * ldq;       // [BQ][D+1]
  float* KT = Gs + BQ * ldq;       // [D][LDT]
  float* VT = KT + D * LDT;        // [D][LDT]
  float* DS = VT + D * LDT;        // [BQ][LDT]
  int* segk = reinterpret_cast<int*>(DS + BQ * LDT);  // [BK]

  const int nq = (S + BQ - 1) / BQ;
  const int q_start = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* g = static_cast<const T*>(p.g) + b * p.sg.b + h * p.sg.h;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  const int* seg = p.seg != nullptr ? p.seg + static_cast<long long>(b) * S
                                    : nullptr;
  const long long row0 = static_cast<long long>(bh) * S;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows(Qs, ldq, q, p.sq.s, q_start, S, D, 1.f);
  load_rows(Gs, ldq, g, p.sg.s, q_start, S, D, 1.f);
  int segq[4];
  float lse[4], delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty * 4 + i;
    const bool in = qp < S;
    segq[i] = (seg != nullptr && in) ? seg[qp] : -1;
    lse[i] = in ? p.lse[row0 + qp] : 0.f;
    delta[i] = in ? p.delta[row0 + qp] : 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int k0, k1;
  key_tiles(p, q_start, &k0, &k1);
  for (int kb = k0; kb < k1; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();
    load_cols(KT, k, p.sk.s, k_start, S, D);
    load_cols(VT, v, p.sv.s, k_start, S, D);
    if (tid < BK) {
      const int kp = k_start + tid;
      segk[tid] = (seg != nullptr && kp < S) ? seg[kp] : -1;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    for (int d = 0; d < D; ++d) {
      float a[4], gg[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * ldq + d];
        gg[i] = Gs[(ty * 4 + i) * ldq + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = KT[d * LDT + tx + 16 * j];
        vv[j] = VT[d * LDT + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qp = q_start + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float sv = s[i][j] * p.scale;
        if (!visible(p, qp, k_start + c, segq[i], segk[c])) sv = NEG_INF;
        const float pr = expf(sv - lse[i]);
        DS[r * LDT + c] = pr * (dp[i][j] - delta[i]) * p.scale;
      }
    }
    __syncwarp();

    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = DS[(ty * 4 + i) * LDT + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float kv = KT[d * LDT + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
        }
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty * 4 + i;
    if (qp < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) store(&dq[qp * p.sdq.s + d], acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int NJ>
__global__ void __launch_bounds__(NT) dkv_kernel(Params p) {
  extern __shared__ float sm[];
  const int D = p.D, S = p.S, ldk = D + 1;
  float* Ks = sm;                  // [BK][D+1]
  float* Vs = Ks + BK * ldk;       // [BK][D+1]
  float* QT = Vs + BK * ldk;       // [D][LDT]
  float* GT = QT + D * LDT;        // [D][LDT]
  float* PT = GT + D * LDT;        // [BK][LDT]: P^T, then dS^T
  float* lse_s = PT + BK * LDT;    // [BQ]
  float* del_s = lse_s + BQ;       // [BQ]
  int* segq = reinterpret_cast<int*>(del_s + BQ);  // [BQ]

  const int k_start = blockIdx.x * BK;
  const int bkv = blockIdx.y, b = bkv / p.KV, kvh = bkv - b * p.KV;
  const int rep = p.H / p.KV;
  const T* k = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* v = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  const int* seg = p.seg != nullptr ? p.seg + static_cast<long long>(b) * S
                                    : nullptr;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_rows(Ks, ldk, k, p.sk.s, k_start, S, D, 1.f);
  load_rows(Vs, ldk, v, p.sv.s, k_start, S, D, 1.f);
  int segk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k_start + ty * 4 + i;
    segk[i] = (seg != nullptr && kp < S) ? seg[kp] : -1;
  }
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = p.causal ? k_start / BQ : 0;
  int q1 = nq;
  if (p.window > 0) q1 = min(q1, (k_start + BK + p.window - 2) / BQ + 1);

  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r, bh = b * p.H + h;
    const T* q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
    const T* g = static_cast<const T*>(p.g) + b * p.sg.b + h * p.sg.h;
    const long long row0 = static_cast<long long>(bh) * S;
    for (int qb = q0; qb < q1; ++qb) {
      const int q_start = qb * BQ;
      __syncthreads();
      load_cols(QT, q, p.sq.s, q_start, S, D);
      load_cols(GT, g, p.sg.s, q_start, S, D);
      if (tid < BQ) {
        const int qp = q_start + tid;
        const bool in = qp < S;
        lse_s[tid] = in ? p.lse[row0 + qp] : 0.f;
        del_s[tid] = in ? p.delta[row0 + qp] : 0.f;
        segq[tid] = (seg != nullptr && in) ? seg[qp] : -1;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      }
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], qq[4], gg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = Ks[(ty * 4 + i) * ldk + d];
          vv[i] = Vs[(ty * 4 + i) * ldk + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qq[j] = QT[d * LDT + tx + 16 * j];
          gg[j] = GT[d * LDT + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gg[j], dp[i][j]);
          }
        }
      }

      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty * 4 + i, kp = k_start + kr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qp = q_start + c;
          float sv = s[i][j] * p.scale;
          if (!(qp < S && visible(p, qp, kp, segq[c], segk[i]))) sv = NEG_INF;
          pr[i][j] = expf(sv - lse_s[c]);
          PT[kr * LDT + c] = pr[i][j];
        }
      }
      __syncwarp();
      for (int c = 0; c < BQ; ++c) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = PT[(ty * 4 + i) * LDT + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float gv = GT[d * LDT + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) dv[i][j] = fmaf(pv[i], gv, dv[i][j]);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          PT[(ty * 4 + i) * LDT + c] =
              pr[i][j] * (dp[i][j] - del_s[c]) * p.scale;
        }
      }
      __syncwarp();
      for (int c = 0; c < BQ; ++c) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = PT[(ty * 4 + i) * LDT + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = tx + 16 * j;
          if (d < D) {
            const float qv = QT[d * LDT + c];
#pragma unroll
            for (int i = 0; i < 4; ++i) dk[i][j] = fmaf(ds[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  T* dvp = static_cast<T*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k_start + ty * 4 + i;
    if (kp < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          store(&dkp[kp * p.sdk.s + d], dk[i][j]);
          store(&dvp[kp * p.sdv.s + d], dv[i][j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

size_t fwd_smem(int D) {
  return sizeof(float) *
         (BQ * (D + 1) + D * LDT + BK * D + BQ * LDT + BK);
}
size_t dq_smem(int D) {
  return sizeof(float) * (2 * BQ * (D + 1) + 2 * D * LDT + BQ * LDT + BK);
}
size_t dkv_smem(int D) {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * D * LDT + BK * LDT + 3 * BQ);
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int NJ>
int launch(Which which, const Params& p, cudaStream_t stream) {
  const int nq = (p.S + BQ - 1) / BQ;
  cudaError_t err;
  if (which == kFwd) {
    const size_t smem = fwd_smem(p.D);
    err = cudaFuncSetAttribute(fwd_kernel<T, NJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fwd_kernel<T, NJ><<<dim3(nq, p.B * p.H), NT, smem, stream>>>(p);
  } else if (which == kDq) {
    const size_t smem = dq_smem(p.D);
    err = cudaFuncSetAttribute(dq_kernel<T, NJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<T, NJ><<<dim3(nq, p.B * p.H), NT, smem, stream>>>(p);
  } else {
    const size_t smem = dkv_smem(p.D);
    err = cudaFuncSetAttribute(dkv_kernel<T, NJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nk = (p.S + BK - 1) / BK;
    dkv_kernel<T, NJ><<<dim3(nk, p.B * p.KV), NT, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(Which which, const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 2>(which, p, stream);
  if (p.D <= 64) return launch<T, 4>(which, p, stream);
  if (p.D <= 96) return launch<T, 6>(which, p, stream);
  return launch<T, 8>(which, p, stream);
}

int run(Which which, Params& p, const long long* strides, int n_strided,
        Str* const* slots, int B, int H, int KV, int S, int D, int causal,
        int window, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || D <= 0 ||
      D > 128 || D % 8 != 0 || B * H > 65535 || (window > 0 && !causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n_strided; ++i) {
    *slots[i] = Str{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(which, p, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(which, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every tensor is [B, H or KV, S, D] with a unit D stride; `strides` holds
// (b, h, s) element strides for each strided tensor in argument order.
// lse and delta are contiguous fp32 [B*H, S]; seg is [B, S] int32 or null.
// dtype: 0 = fp32, 1 = bf16.  Each call launches on `stream` and returns
// cudaGetLastError() (0 on success).

extern "C" int dlr_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, const int* seg,
                             const long long* strides, int B, int H, int KV,
                             int S, int D, int causal, int window,
                             float scale, int dtype, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.seg = seg;
  Str* slots[] = {&p.sq, &p.sk, &p.sv, &p.so};
  return run(kFwd, p, strides, 4, slots, B, H, KV, S, D, causal, window,
             scale, dtype, stream);
}

extern "C" int dlr_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* g, const float* lse,
                                const float* delta, const int* seg, void* dq,
                                const long long* strides, int B, int H,
                                int KV, int S, int D, int causal, int window,
                                float scale, int dtype, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.seg = seg;
  p.dq = dq;
  Str* slots[] = {&p.sq, &p.sk, &p.sv, &p.sg, &p.sdq};
  return run(kDq, p, strides, 5, slots, B, H, KV, S, D, causal, window,
             scale, dtype, stream);
}

extern "C" int dlr_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const float* lse,
                                 const float* delta, const int* seg,
                                 void* dk, void* dv, const long long* strides,
                                 int B, int H, int KV, int S, int D,
                                 int causal, int window, float scale,
                                 int dtype, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.seg = seg;
  p.dk = dk;
  p.dv = dv;
  Str* slots[] = {&p.sq, &p.sk, &p.sv, &p.sg, &p.sdk, &p.sdv};
  return run(kDkv, p, strides, 6, slots, B, H, KV, S, D, causal, window,
             scale, dtype, stream);
}
