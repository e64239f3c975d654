// Flash attention for Hopper (sm_90a): the forward, dq and dk/dv kernels,
// bound to PyTorch through ctypes by dlrover_tpu_torch/ops/flash_attention.py.
//
// Replaces the Pallas TPU kernels of dlrover_tpu/ops/flash_attention.py:
//   flash_fwd_wgmma (bf16), fwd_kernel (fp32)  <- _fwd_kernel
//   flash_dq_wgmma (bf16), dq_kernel (fp32)    <- _bwd_dq_kernel
//   flash_dkv_wgmma (bf16), dkv_kernel (fp32)  <- _bwd_dkv_kernel
// with the same arithmetic: every mask the finite NEG_INF = -1e30; l
// floored at 1e-30 and lse = m + log(l); p = exp(s - lse) recomputed in the
// backward; P (and dS) kept at fp32 precision for the PV, dV and dK
// products; dq written once in q's dtype; dk/dv summed in fp32 over the
// query heads of one KV head and cast once.  The C entry points route by
// dtype: bf16 runs on the tensor cores, fp32 on the CUDA cores.
//
// What bounds it: operations.  At the Llama-800M training shape (B 4, H 16,
// S 2048, D 96, causal) the forward does 2 products over the S(S+1)/2
// visible pairs of each head, ~51.5 GFLOP, against ~100 MB of q, k, v and
// out: ~52 us at the bf16 tensor-core peak (989 TFLOP/s), far above the
// memory bound (~30 us at 3.35 TB/s); dq does 3 products (~78 us) and dk/dv
// 4 (~104 us).
//
// Tensor-core kernels (bf16).  Hopper's warpgroup products (wgmma) on bf16
// tiles in shared memory, filled by cp.async through a two-stage ring so the
// next tile's copy overlaps this tile's products.  The forward
// (flash_fwd_wgmma) gives each block 128 query rows of one (batch, head), two
// warpgroups of 64 rows, over 64-key tiles: S = Q K^T from shared memory into
// fp32 registers, then the masks and the online softmax in fp32 registers.  The
// reference keeps P in fp32; a single bf16 P would err by ~2^-9 of a row's
// weighted |v|, which breaks a 2-ulp tolerance where an output cancels to near
// zero.  So P is split into two bf16 values, hi = bf16(p) and lo = bf16(p -
// hi), and O += P_hi V + P_lo V runs as two products with A taken from
// registers into one fp32 accumulator: ~2^-17 relative, fp32-grade, at 3
// products instead of 2.  Q K^T is exact as it stands (bf16 products summed in
// fp32).  The dq kernel (flash_dq_wgmma) is the forward's block and K/V ring
// with dO resident beside Q and the saved lse in place of the online softmax: S
// = Q K^T and dP = dO V^T from shared memory, dS = exp(S scale - lse) (dP -
// delta) scale in fp32 registers, and dQ += dS_hi K + dS_lo K with K read
// MN-major (4 products where the reference has 3; P itself enters no product
// and needs no split).  The dk/dv kernel (flash_dkv_wgmma) gives each block 64
// keys of one (batch, KV head), one warpgroup, K and V resident, and loops over
// the GQA group's query heads and their visible query tiles, summing dK and dV
// in registers (no atomics: the result is the same bit for bit on every run).
// It computes S^T = K Q^T and dP^T = V dO^T, so the accumulators already hold
// P^T and dS^T in the layout of an A operand, and dV += P^T dO, dK += dS^T Q
// each take the hi/lo split (6 products where the reference has 4).  D is
// padded in shared memory (never in device memory) to 64, 96 or 128 with zeros
// by the copy itself; rows past S are zero-filled the same way and masked.
//
// CUDA-core kernels (fp32).  One block of 256 threads per (64-row tile,
// batch*head) for the forward and dq (grid x walks the tiles last-first, so the
// longest causal rows start first), and per (64-key tile, batch*KV head) for
// dk/dv.  Tiles stream through shared memory as fp32; k, v (forward, dq) or q,
// g (dk/dv) are stored transposed with a row pitch of 65 floats, so both the
// tile product and the accumulation read shared memory without bank conflicts.
// Each thread owns a 4x4 micro-tile of the 64x64 score block and a 4 x D/16
// slice of the output; a row's 64 scores live in one half-warp.  Peak 67
// TFLOP/s.
//
// Both families skip causal blocks beyond the diagonal and, with a window,
// blocks below it, as the reference does; read GQA's KV head (h / (H/KV))
// in place; mask a ragged S inside the kernel (loads past S read zero, keys
// and queries past S are masked), never padded by copies; and take any head
// dim D <= 128 that is a multiple of 8 (D = 96 at 800M is not a power of
// two) and strided [B, S, H, D] views.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;     // query rows per tile
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads per block: 16 row groups x 16 columns
constexpr int LDT = 65;    // pitch of the transposed [D][64] tiles
constexpr float NEG_INF = -1e30f;

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

// Key tiles [k0, k1) of BK keys that `rows` queries from q_start visit.
__device__ __forceinline__ void key_tiles(const Params& p, int q_start,
                                          int rows, int* k0, int* k1) {
  int hi = (p.S + BK - 1) / BK;
  if (p.causal) hi = min(hi, (q_start + rows - 1) / BK + 1);
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
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long stride, int row0,
                                          int S, int D, float mul) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i - r * D, pos = row0 + r;
    dst[r * ld + d] = pos < S ? src[pos * stride + d] * mul : 0.f;
  }
}

// Transposed [D][64] tile (pitch LDT) of a [S, D] slice at row0.
__device__ __forceinline__ void load_cols(float* dst, const float* src,
                                          long long stride, int row0, int S,
                                          int D) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, d = i - r * D, pos = row0 + r;
    dst[d * LDT + r] = pos < S ? src[pos * stride + d] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Forward (CUDA cores; fp32 only, bf16 runs tc::flash_fwd_wgmma)
// ---------------------------------------------------------------------------

template <int NJ>
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
  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + kvh * p.sv.h;
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
  key_tiles(p, q_start, BQ, &k0, &k1);
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

  float* o = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty * 4 + i;
    if (qp < S) {
      const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) o[qp * p.so.s + d] = acc[i][j] / ls;
      }
      if (tx == 0) p.lse[static_cast<long long>(bh) * S + qp] = m[i] + logf(ls);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dq (CUDA cores; fp32 only, bf16 runs tc::flash_dq_wgmma)
// ---------------------------------------------------------------------------

template <int NJ>
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
  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* g = static_cast<const float*>(p.g) + b * p.sg.b + h * p.sg.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + kvh * p.sv.h;
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
  key_tiles(p, q_start, BQ, &k0, &k1);
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

  float* dq = static_cast<float*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_start + ty * 4 + i;
    if (qp < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) dq[qp * p.sdq.s + d] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: dk, dv (CUDA cores; fp32 only, bf16 runs tc::flash_dkv_wgmma)
// ---------------------------------------------------------------------------

template <int NJ>
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
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + kvh * p.sv.h;
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
    const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
    const float* g = static_cast<const float*>(p.g) + b * p.sg.b + h * p.sg.h;
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

  float* dkp = static_cast<float*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  float* dvp = static_cast<float*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k_start + ty * 4 + i;
    if (kp < S) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          dkp[kp * p.sdk.s + d] = dk[i][j];
          dvp[kp * p.sdv.s + d] = dv[i][j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16): wgmma on shared-memory tiles
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes from global to shared memory; when `full` is false the
// source is not read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's completed shared-memory writes visible to the
// wgmma operand reads (the async proxy) that follow the next barrier.
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses to registers that an in-flight
// wgmma reads or writes across the fence, commit and wait around it.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory tiles: R x DP bf16 in the core-matrix layout without
// swizzle, element (r, c) at byte
//   ((r / 8) * (DP / 8) + c / 8) * 128 + (r % 8) * 16 + (c % 8) * 2,
// so each 8 x 8 core matrix is 128 contiguous bytes.  One layout serves
// every operand: read K-major (rows = M or N, columns = K) for the
// products over D, and MN-major (rows = K, columns = N, transpose bit set)
// for the products over keys or queries.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}
// K-major operand of 64 rows from row r0 (a multiple of 8), K-slice kk
// (columns 16 kk .. 16 kk + 15): the leading offset steps along K (the
// next 8 columns), the stride offset along rows (the next 8 rows).
template <int DP>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return make_desc(tile + r0 * DP * 2 + kk * 256, 128, DP * 16);
}
// MN-major operand (N = DP columns), K-slice kk (rows 16 kk .. 16 kk +
// 15): the leading offset steps along K (the next 8 rows), the stride
// offset along N (the next 8 columns).
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * DP * 32, DP * 16, 128);
}

// Copies rows [row0, row0 + R) of a [S, D] slice (row stride ld elements)
// into a tile at dst.  Rows past S and columns past D are zero-filled by
// the copy itself (src-size 0) and never read.  Eight consecutive threads
// fill one core matrix (128 contiguous bytes), so the 16-byte stores of a
// quarter-warp hit distinct banks; chunk i lands at byte 16 i.
template <int R, int DP, int NTHR>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ld, int row0, int S,
                                          int D, int tid) {
  constexpr int CPR = DP / 8;  // 16-byte chunks a row
  static_assert((R * CPR) % NTHR == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < R * CPR / NTHR; ++it) {
    const int i = tid + it * NTHR;
    const int rest = i >> 3, cc = rest % CPR;
    const int pos = row0 + (rest / CPR) * 8 + (i & 7);
    const bool in = pos < S && cc * 8 < D;
    cp_async16(dst + 16 * i, in ? src + pos * ld + cc * 8 : src, in);
  }
}

// Rounds (x0, x1) to a bf16 pair `hi` and the rest to a bf16 pair `lo`:
// hi + lo equals (x0, x1) within ~2^-17 relative.  Low half = x0, the
// lower column, as an A fragment register holds it.
__device__ __forceinline__ void split(float x0, float x1, uint32_t* hi,
                                      uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void store2(bf16* dst, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The warpgroup products.  Accumulator layout (m64nN, fp32, N / 2
// registers a thread): warp w of the warpgroup holds rows 16 w .. 16 w +
// 15; in each 8-column chunk j a thread holds d[4j], d[4j + 1] at row
// lane / 4, columns 8 j + 2 (lane % 4) + {0, 1}, and d[4j + 2], d[4j + 3]
// at row lane / 4 + 8.  The A fragment of K-slice kk (16 columns) is then
// the bf16 pairs (d[8kk], d[8kk+1]), (d[8kk+2], d[8kk+3]), (d[8kk+4],
// d[8kk+5]), (d[8kk+6], d[8kk+7]): an accumulator feeds the next product
// with no data movement.
#define D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d {+}= A B, A and B from shared memory, both K-major; `accumulate` 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A (bf16 pairs, the fragment layout above) from registers, B
// from shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef D8

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, accumulate);
  } else {
    static_assert(N == 64, "S tiles are 32 or 64 wide");
    wgmma_ss_n64(d, a, b, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (N == 96) {
    wgmma_rs_n96(d, a, b);
  } else {
    static_assert(N == 128, "D pads to 64, 96 or 128");
    wgmma_rs_n128(d, a, b);
  }
}

// ---- Forward --------------------------------------------------------------

// 96-99 KB of shared memory at D 128 would let two blocks share an SM, but
// the registers (185 a thread at D 128) hold it to one.
template <int DP>
struct Fwd {
  static constexpr int BM = 128;  // query rows a block: two warpgroups
  static constexpr int BN = 64;   // keys a tile
  static constexpr int NST = 2;   // ring stages
  static constexpr int NT = 256;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int T_BYTES = BN * DP * 2;
  static constexpr int STAGE = 2 * T_BYTES + BN * 4;  // K, V, key segments
  static constexpr int SMEM = Q_BYTES + NST * STAGE;
};

// Key tile j (BN keys) into one stage of the forward's (and dq's) ring at
// base: K, V, then the keys' segments.
template <int DP>
__device__ __forceinline__ void load_kv(uint32_t base, const bf16* k,
                                        const bf16* v, const int* seg,
                                        const Params& p, int j, int tid) {
  using C = Fwd<DP>;
  const int k_start = j * C::BN;
  load_tile<C::BN, DP, C::NT>(base, k, p.sk.s, k_start, p.S, p.D, tid);
  load_tile<C::BN, DP, C::NT>(base + C::T_BYTES, v, p.sv.s, k_start, p.S,
                              p.D, tid);
  if (seg != nullptr && tid < C::BN) {
    const int kp = k_start + tid;
    cp_async4(base + 2 * C::T_BYTES + 4 * tid, kp < p.S ? seg + kp : seg,
              kp < p.S);
  }
}

// Whether a warpgroup's 64 query rows from w_first see any key of the
// 64-key tile at k_start (uniform over the warpgroup, so the whole
// warpgroup skips or issues its products).
__device__ __forceinline__ bool tile_live(const Params& p, int w_first,
                                          int k_start) {
  return w_first < p.S && (!p.causal || k_start <= w_first + 63) &&
         (p.window == 0 || k_start + 63 > w_first - p.window);
}

// Whether some pair of those rows and that tile is masked, so that the
// tile takes the per-element test.
__device__ __forceinline__ bool tile_edge(const Params& p, int w_first,
                                          int k_start) {
  return p.seg != nullptr || k_start + 64 > p.S ||
         (p.causal && k_start + 63 > w_first) ||
         (p.window > 0 && w_first + 63 - k_start >= p.window);
}

template <int DP>
__global__ void __launch_bounds__(256, 1) flash_fwd_wgmma(Params p) {
  using C = Fwd<DP>;
  constexpr int NO = DP / 2;  // O accumulator registers a thread
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem), s_ring = s_q + C::Q_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid & 127) >> 5;
  const int S = p.S, D = p.D;
  const int nq = (S + C::BM - 1) / C::BM;
  const int q_start = (nq - 1 - static_cast<int>(blockIdx.x)) * C::BM;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  const int* seg = p.seg != nullptr ? p.seg + static_cast<long long>(b) * S
                                    : nullptr;

  // This warpgroup's 64 rows, and this thread's two of them.
  const int w_first = q_start + wg * 64;
  const int r0 = w_first + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);  // first column of its pair in each chunk
  int seg0 = -1, seg1 = -1;
  if (seg != nullptr) {
    if (r0 < S) seg0 = seg[r0];
    if (r1 < S) seg1 = seg[r1];
  }

  load_tile<C::BM, DP, C::NT>(s_q, q, p.sq.s, q_start, S, D, tid);
  cp_commit();

  int k0, k1;
  key_tiles(p, q_start, C::BM, &k0, &k1);
#pragma unroll
  for (int st = 0; st < C::NST - 1; ++st) {
    if (k0 + st < k1) {
      load_kv<DP>(s_ring + st * C::STAGE, k, v, seg, p, k0 + st, tid);
    }
    cp_commit();
  }

  float o[NO], s[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  uint32_t ph[16], pl[16];  // P as bf16 hi / lo pairs: 4 K-slices x 4

  for (int j = k0; j < k1; ++j) {
    const int it = j - k0;
    if (j + C::NST - 1 < k1) {
      load_kv<DP>(s_ring + (it + C::NST - 1) % C::NST * C::STAGE, k, v, seg,
                  p, j + C::NST - 1, tid);
    }
    cp_commit();
    cp_wait<C::NST - 1>();
    async_fence();
    __syncthreads();

    const int k_start = j * C::BN;
    if (tile_live(p, w_first, k_start)) {
      const int stage = it % C::NST;
      const uint32_t s_k = s_ring + stage * C::STAGE;
      const uint32_t s_v = s_k + C::T_BYTES;
      const int* segk = reinterpret_cast<const int*>(
          smem + C::Q_BYTES + stage * C::STAGE + 2 * C::T_BYTES);

      pin<32>(s);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<64>(s, desc_k<DP>(s_q, wg * 64, kk), desc_k<DP>(s_k, 0, kk),
                     kk > 0);
      }
      mma_commit();
      mma_wait<0>();
      pin<32>(s);

      const bool edge = tile_edge(p, w_first, k_start);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * p.scale;
        if (edge) {
          const int kc = 8 * (i >> 2) + cq + (i & 1);
          const bool second = (i & 2) != 0;
          if (!visible(p, second ? r1 : r0, k_start + kc,
                       second ? seg1 : seg0, seg != nullptr ? segk[kc] : 0)) {
            x = NEG_INF;
          }
        }
        s[i] = x;
        if (i & 2) {
          mx1 = fmaxf(mx1, x);
        } else {
          mx0 = fmaxf(mx0, x);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f((m0 - mn0) * LOG2E);
      const float a1 = exp2f((m1 - mn1) * LOG2E);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float mn = (i & 2) ? mn1 : mn0;
        const float e0 = exp2f((s[i] - mn) * LOG2E);
        const float e1 = exp2f((s[i + 1] - mn) * LOG2E);
        if (i & 2) {
          sum1 += e0 + e1;
        } else {
          sum0 += e0 + e1;
        }
        split(e0, e1, &ph[i >> 1], &pl[i >> 1]);
      }
      l0 = l0 * a0 + quad_sum(sum0);
      l1 = l1 * a1 + quad_sum(sum1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? a1 : a0;

      pin<NO>(o);
      pin<16>(ph);
      pin<16>(pl);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DP>(o, ph + 4 * kk, desc_mn<DP>(s_v, kk));
        wgmma_rs<DP>(o, pl + 4 * kk, desc_mn<DP>(s_v, kk));
      }
      mma_commit();
      mma_wait<0>();
      pin<NO>(o);
      pin<16>(ph);
      pin<16>(pl);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }

  if (w_first < S) {
    bf16* out = static_cast<bf16*>(p.o) + b * p.so.b + h * p.so.h;
    const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + cq;
      if (col < D) {
        if (r0 < S) {
          store2(out + r0 * p.so.s + col, o[4 * c] / ls0, o[4 * c + 1] / ls0);
        }
        if (r1 < S) {
          store2(out + r1 * p.so.s + col, o[4 * c + 2] / ls1,
                 o[4 * c + 3] / ls1);
        }
      }
    }
    if ((lane & 3) == 0) {
      const long long row = static_cast<long long>(bh) * S;
      if (r0 < S) p.lse[row + r0] = m0 + logf(ls0);
      if (r1 < S) p.lse[row + r1] = m1 + logf(ls1);
    }
  }
}

// ---- dQ -------------------------------------------------------------------

// The forward's block and K/V ring, with dO resident beside Q: 128 KB of
// shared memory at D 128.
template <int DP>
struct Dq : Fwd<DP> {
  using F = Fwd<DP>;
  static constexpr int SMEM = 2 * F::Q_BYTES + F::NST * F::STAGE;
};

// The forward with its softmax state replaced by the saved lse and delta:
// S = Q K^T and dP = dO V^T from shared memory, P = exp(S scale - lse) and
// dS = P (dP - delta) scale in fp32 registers, then dQ += dS_hi K + dS_lo K
// with A from those registers and K read MN-major, as the forward reads V.
// Each block owns its rows of dQ: no atomics, a repeat is bit-identical.
template <int DP>
__global__ void __launch_bounds__(256, 1) flash_dq_wgmma(Params p) {
  using C = Dq<DP>;
  constexpr int NO = DP / 2;  // dQ accumulator registers a thread
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem), s_g = s_q + C::Q_BYTES;
  const uint32_t s_ring = s_g + C::Q_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid & 127) >> 5;
  const int S = p.S, D = p.D;
  const int nq = (S + C::BM - 1) / C::BM;
  const int q_start = (nq - 1 - static_cast<int>(blockIdx.x)) * C::BM;
  const int bh = blockIdx.y, b = bh / p.H, h = bh - b * p.H;
  const int kvh = h / (p.H / p.KV);
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const bf16* g = static_cast<const bf16*>(p.g) + b * p.sg.b + h * p.sg.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  const int* seg = p.seg != nullptr ? p.seg + static_cast<long long>(b) * S
                                    : nullptr;

  // This warpgroup's 64 rows, and this thread's two of them with their lse
  // and delta (0 past S: those rows are never stored).
  const int w_first = q_start + wg * 64;
  const int r0 = w_first + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int cq = 2 * (lane & 3);
  const long long row = static_cast<long long>(bh) * S;
  int seg0 = -1, seg1 = -1;
  float lse0 = 0.f, lse1 = 0.f, del0 = 0.f, del1 = 0.f;
  if (r0 < S) {
    lse0 = p.lse[row + r0];
    del0 = p.delta[row + r0];
    if (seg != nullptr) seg0 = seg[r0];
  }
  if (r1 < S) {
    lse1 = p.lse[row + r1];
    del1 = p.delta[row + r1];
    if (seg != nullptr) seg1 = seg[r1];
  }

  load_tile<C::BM, DP, C::NT>(s_q, q, p.sq.s, q_start, S, D, tid);
  load_tile<C::BM, DP, C::NT>(s_g, g, p.sg.s, q_start, S, D, tid);
  cp_commit();

  int k0, k1;
  key_tiles(p, q_start, C::BM, &k0, &k1);
#pragma unroll
  for (int st = 0; st < C::NST - 1; ++st) {
    if (k0 + st < k1) {
      load_kv<DP>(s_ring + st * C::STAGE, k, v, seg, p, k0 + st, tid);
    }
    cp_commit();
  }

  float dq[NO], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  uint32_t fh[16], fl[16];  // dS as bf16 hi / lo pairs: 4 K-slices x 4

  for (int j = k0; j < k1; ++j) {
    const int it = j - k0;
    if (j + C::NST - 1 < k1) {
      load_kv<DP>(s_ring + (it + C::NST - 1) % C::NST * C::STAGE, k, v, seg,
                  p, j + C::NST - 1, tid);
    }
    cp_commit();
    cp_wait<C::NST - 1>();
    async_fence();
    __syncthreads();

    const int k_start = j * C::BN;
    if (tile_live(p, w_first, k_start)) {
      const int stage = it % C::NST;
      const uint32_t s_k = s_ring + stage * C::STAGE;
      const uint32_t s_v = s_k + C::T_BYTES;
      const int* segk = reinterpret_cast<const int*>(
          smem + 2 * C::Q_BYTES + stage * C::STAGE + 2 * C::T_BYTES);

      pin<32>(s);
      pin<32>(dp);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<64>(s, desc_k<DP>(s_q, wg * 64, kk), desc_k<DP>(s_k, 0, kk),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<64>(dp, desc_k<DP>(s_g, wg * 64, kk),
                     desc_k<DP>(s_v, 0, kk), kk > 0);
      }
      mma_commit();
      mma_wait<0>();
      pin<32>(s);
      pin<32>(dp);

      // dS = exp(S scale - lse) (dP - delta) scale, as hi/lo pairs.
      const bool edge = tile_edge(p, w_first, k_start);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const bool second = (i & 2) != 0;
        const float ls = second ? lse1 : lse0, dl = second ? del1 : del0;
        float x0 = s[i] * p.scale, x1 = s[i + 1] * p.scale;
        if (edge) {
          const int kc = 8 * (i >> 2) + cq;  // key of s[i]; s[i + 1] is kc + 1
          const int qp = second ? r1 : r0, sq = second ? seg1 : seg0;
          if (!visible(p, qp, k_start + kc, sq,
                       seg != nullptr ? segk[kc] : 0)) {
            x0 = NEG_INF;
          }
          if (!visible(p, qp, k_start + kc + 1, sq,
                       seg != nullptr ? segk[kc + 1] : 0)) {
            x1 = NEG_INF;
          }
        }
        const float p0 = exp2f((x0 - ls) * LOG2E);
        const float p1 = exp2f((x1 - ls) * LOG2E);
        split(p0 * (dp[i] - dl) * p.scale, p1 * (dp[i + 1] - dl) * p.scale,
              &fh[i >> 1], &fl[i >> 1]);
      }

      pin<NO>(dq);
      pin<16>(fh);
      pin<16>(fl);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DP>(dq, fh + 4 * kk, desc_mn<DP>(s_k, kk));
        wgmma_rs<DP>(dq, fl + 4 * kk, desc_mn<DP>(s_k, kk));
      }
      mma_commit();
      mma_wait<0>();
      pin<NO>(dq);
      pin<16>(fh);
      pin<16>(fl);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }

  if (w_first < S) {
    bf16* out = static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + cq;
      if (col < D) {
        if (r0 < S) store2(out + r0 * p.sdq.s + col, dq[4 * c], dq[4 * c + 1]);
        if (r1 < S) {
          store2(out + r1 * p.sdq.s + col, dq[4 * c + 2], dq[4 * c + 3]);
        }
      }
    }
  }
}

// ---- dK, dV ---------------------------------------------------------------

template <int DP>
struct Dkv {
  static constexpr int BN = 64;                   // keys a block
  // Queries a tile: with 64, S^T, dP^T and the fragments fit beside dK and
  // dV without spills up to D 96; at D 128 they would spill, so 32 there.
  static constexpr int BQ = DP <= 96 ? 64 : 32;
  static constexpr int NST = 2;
  static constexpr int NT = 128;                  // one warpgroup
  static constexpr int KV_BYTES = BN * DP * 2;
  static constexpr int T_BYTES = BQ * DP * 2;
  // Q, dO, then lse, delta and query segments of the tile.
  static constexpr int STAGE = 2 * T_BYTES + 3 * BQ * 4;
  static constexpr int SMEM = 2 * KV_BYTES + NST * STAGE;
};

template <int DP>
__global__ void __launch_bounds__(128) flash_dkv_wgmma(Params p) {
  using C = Dkv<DP>;
  constexpr int BQ = C::BQ;
  constexpr int NA = DP / 2;  // dK, dV accumulator registers a thread
  constexpr int NS = BQ / 2;  // S^T, dP^T registers a thread
  constexpr int NF = BQ / 4;  // hi (or lo) fragment registers: BQ/16 x 4
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = smem_u32(smem), s_v = s_k + C::KV_BYTES;
  const uint32_t s_ring = s_v + C::KV_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = p.S, D = p.D;
  const int k_start = blockIdx.x * C::BN;
  const int bkv = blockIdx.y, b = bkv / p.KV, kvh = bkv - b * p.KV;
  const int rep = p.H / p.KV;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  const int* seg = p.seg != nullptr ? p.seg + static_cast<long long>(b) * S
                                    : nullptr;
  // This thread's two keys (rows of the accumulators).
  const int kr0 = k_start + warp * 16 + (lane >> 2), kr1 = kr0 + 8;
  const int cq = 2 * (lane & 3);
  int seg0 = -1, seg1 = -1;
  if (seg != nullptr) {
    if (kr0 < S) seg0 = seg[kr0];
    if (kr1 < S) seg1 = seg[kr1];
  }

  load_tile<C::BN, DP, C::NT>(s_k, k, p.sk.s, k_start, S, D, tid);
  load_tile<C::BN, DP, C::NT>(s_v, v, p.sv.s, k_start, S, D, tid);
  cp_commit();

  // Query tiles [q0, q1) of each head of the group see these keys.
  const int nq = (S + BQ - 1) / BQ;
  const int q0 = p.causal ? k_start / BQ : 0;
  int q1 = nq;
  if (p.window > 0) q1 = min(q1, (k_start + C::BN + p.window - 2) / BQ + 1);
  const int nqt = max(q1 - q0, 0), n_tiles = rep * nqt;

  auto load_q = [&](int t, int stage) {
    const int r = t / nqt, h = kvh * rep + r, q_start = (q0 + t - r * nqt) * BQ;
    const long long row0 = static_cast<long long>(b * p.H + h) * S;
    const bf16* q = static_cast<const bf16*>(p.q) + b * p.sq.b + h * p.sq.h;
    const bf16* g = static_cast<const bf16*>(p.g) + b * p.sg.b + h * p.sg.h;
    const uint32_t base = s_ring + stage * C::STAGE;
    load_tile<BQ, DP, C::NT>(base, q, p.sq.s, q_start, S, D, tid);
    load_tile<BQ, DP, C::NT>(base + C::T_BYTES, g, p.sg.s, q_start, S, D,
                             tid);
    if (tid < BQ) {
      const int qp = q_start + tid;
      const bool in = qp < S;
      const uint32_t vec = base + 2 * C::T_BYTES + 4 * tid;
      cp_async4(vec, in ? p.lse + row0 + qp : p.lse, in);
      cp_async4(vec + 4 * BQ, in ? p.delta + row0 + qp : p.delta, in);
      if (seg != nullptr) cp_async4(vec + 8 * BQ, in ? seg + qp : seg, in);
    }
  };
#pragma unroll
  for (int st = 0; st < C::NST - 1; ++st) {
    if (st < n_tiles) load_q(st, st);
    cp_commit();
  }

  float dk[NA], dv[NA], s[NS], dp[NS];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
  uint32_t fh[NF], fl[NF];

  for (int t = 0; t < n_tiles; ++t) {
    if (t + C::NST - 1 < n_tiles) {
      load_q(t + C::NST - 1, (t + C::NST - 1) % C::NST);
    }
    cp_commit();
    cp_wait<C::NST - 1>();
    async_fence();
    __syncthreads();

    const int stage = t % C::NST;
    const int q_start = (q0 + t % nqt) * BQ;
    const uint32_t s_q = s_ring + stage * C::STAGE;
    const uint32_t s_g = s_q + C::T_BYTES;
    const float* lse = reinterpret_cast<const float*>(
        smem + 2 * C::KV_BYTES + stage * C::STAGE + 2 * C::T_BYTES);
    const float* delta = lse + BQ;
    const int* segq = reinterpret_cast<const int*>(delta + BQ);

    // S^T = K Q^T and dP^T = V dO^T over D.
    pin<NS>(s);
    pin<NS>(dp);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<BQ>(s, desc_k<DP>(s_k, 0, kk), desc_k<DP>(s_q, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      wgmma_ss<BQ>(dp, desc_k<DP>(s_v, 0, kk), desc_k<DP>(s_g, 0, kk),
                   kk > 0);
    }
    mma_commit();
    mma_wait<0>();
    pin<NS>(s);
    pin<NS>(dp);

    // P^T = exp(S^T scale - lse), in fp32 and as hi/lo pairs.
    const bool edge = seg != nullptr || q_start + BQ > S ||
                      k_start + C::BN > S ||
                      (p.causal && q_start < k_start + C::BN - 1) ||
                      (p.window > 0 && q_start + BQ - 1 - k_start >= p.window);
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int c = 8 * (i >> 2) + cq;  // query of s[i]; s[i + 1] is c + 1
      const float2 ls = *reinterpret_cast<const float2*>(lse + c);
      float x0 = s[i] * p.scale, x1 = s[i + 1] * p.scale;
      if (edge) {
        const bool second = (i & 2) != 0;
        const int kp = second ? kr1 : kr0, sk = second ? seg1 : seg0;
        const int sq0 = seg != nullptr ? segq[c] : 0;
        const int sq1 = seg != nullptr ? segq[c + 1] : 0;
        const int qp = q_start + c;
        if (!(qp < S && visible(p, qp, kp, sq0, sk))) x0 = NEG_INF;
        if (!(qp + 1 < S && visible(p, qp + 1, kp, sq1, sk))) x1 = NEG_INF;
      }
      s[i] = exp2f((x0 - ls.x) * LOG2E);
      s[i + 1] = exp2f((x1 - ls.y) * LOG2E);
      split(s[i], s[i + 1], &fh[i >> 1], &fl[i >> 1]);
    }

    // dV += P^T dO (hi and lo), while dS^T = P^T (dP^T - delta) scale.
    pin<NA>(dv);
    pin<NF>(fh);
    pin<NF>(fl);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<DP>(dv, fh + 4 * kk, desc_mn<DP>(s_g, kk));
      wgmma_rs<DP>(dv, fl + 4 * kk, desc_mn<DP>(s_g, kk));
    }
    mma_commit();
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 8 * (i >> 2) + cq + (i & 1);
      dp[i] = s[i] * (dp[i] - delta[c]) * p.scale;
    }
    mma_wait<0>();
    pin<NA>(dv);
    pin<NF>(fh);
    pin<NF>(fl);

    // dK += dS^T Q (hi and lo).
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      split(dp[i], dp[i + 1], &fh[i >> 1], &fl[i >> 1]);
    }
    pin<NA>(dk);
    pin<NF>(fh);
    pin<NF>(fl);
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<DP>(dk, fh + 4 * kk, desc_mn<DP>(s_q, kk));
      wgmma_rs<DP>(dk, fl + 4 * kk, desc_mn<DP>(s_q, kk));
    }
    mma_commit();
    mma_wait<0>();
    pin<NA>(dk);
    pin<NF>(fh);
    pin<NF>(fl);
    __syncthreads();  // done with this stage before it is refilled
  }

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.sdk.b + kvh * p.sdk.h;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.sdv.b + kvh * p.sdv.h;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = 8 * c + cq;
    if (col < D) {
      if (kr0 < S) {
        store2(dkp + kr0 * p.sdk.s + col, dk[4 * c], dk[4 * c + 1]);
        store2(dvp + kr0 * p.sdv.s + col, dv[4 * c], dv[4 * c + 1]);
      }
      if (kr1 < S) {
        store2(dkp + kr1 * p.sdk.s + col, dk[4 * c + 2], dk[4 * c + 3]);
        store2(dvp + kr1 * p.sdv.s + col, dv[4 * c + 2], dv[4 * c + 3]);
      }
    }
  }
}

// ---- Layout probe ---------------------------------------------------------

// One 64 x 64 tile (D 64) through both product forms, for the card test of
// the shared-memory layout and of the accumulator-to-A-fragment step: s =
// q k^T (A and B from shared memory, K-major), written out as the
// accumulator holds it, and o = hi(s) v + lo(s) v (A from s's registers, v
// MN-major).  q, k, v are contiguous [64, 64]; s and o fp32 [64, 64].
__global__ void __launch_bounds__(128)
    wgmma_tile_probe(const bf16* q, const bf16* k, const bf16* v,
                     float* s_out, float* o_out) {
  __shared__ __align__(128) unsigned char smem[3 * 64 * 64 * 2];
  const uint32_t s_q = smem_u32(smem), s_k = s_q + 8192, s_v = s_k + 8192;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_tile<64, 64, 128>(s_q, q, 64, 0, 64, 64, tid);
  load_tile<64, 64, 128>(s_k, k, 64, 0, 64, 64, tid);
  load_tile<64, 64, 128>(s_v, v, 64, 0, 64, 64, tid);
  cp_commit();
  cp_wait<0>();
  async_fence();
  __syncthreads();

  float s[32], o[32];
  uint32_t fh[16], fl[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;
  pin<32>(s);
  mma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss<64>(s, desc_k<64>(s_q, 0, kk), desc_k<64>(s_k, 0, kk), kk > 0);
  }
  mma_commit();
  mma_wait<0>();
  pin<32>(s);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    split(s[i], s[i + 1], &fh[i >> 1], &fl[i >> 1]);
  }
  pin<32>(o);
  pin<16>(fh);
  pin<16>(fl);
  mma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<64>(o, fh + 4 * kk, desc_mn<64>(s_v, kk));
    wgmma_rs<64>(o, fl + 4 * kk, desc_mn<64>(s_v, kk));
  }
  mma_commit();
  mma_wait<0>();
  pin<32>(o);
  pin<16>(fh);
  pin<16>(fl);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = warp * 16 + (lane >> 2) + ((i & 2) ? 8 : 0);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    s_out[row * 64 + col] = s[i];
    o_out[row * 64 + col] = o[i];
  }
}

}  // namespace tc

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

template <typename K>
int set_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// CUDA-core kernels (fp32): the forward, dq and dk/dv.
template <int NJ>
int launch(Which which, const Params& p, cudaStream_t stream) {
  const int nq = (p.S + BQ - 1) / BQ;
  int err;
  if (which == kFwd) {
    const size_t smem = fwd_smem(p.D);
    err = set_smem(fwd_kernel<NJ>, smem);
    if (err != 0) return err;
    fwd_kernel<NJ><<<dim3(nq, p.B * p.H), NT, smem, stream>>>(p);
  } else if (which == kDq) {
    const size_t smem = dq_smem(p.D);
    err = set_smem(dq_kernel<NJ>, smem);
    if (err != 0) return err;
    dq_kernel<NJ><<<dim3(nq, p.B * p.H), NT, smem, stream>>>(p);
  } else {
    const size_t smem = dkv_smem(p.D);
    err = set_smem(dkv_kernel<NJ>, smem);
    if (err != 0) return err;
    const int nk = (p.S + BK - 1) / BK;
    dkv_kernel<NJ><<<dim3(nk, p.B * p.KV), NT, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(Which which, const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<2>(which, p, stream);
  if (p.D <= 64) return launch<4>(which, p, stream);
  if (p.D <= 96) return launch<6>(which, p, stream);
  return launch<8>(which, p, stream);
}

// Tensor-core kernels (bf16), D padded to DP.
template <int DP>
int launch_tc(Which which, const Params& p, cudaStream_t stream) {
  int err;
  if (which == kFwd) {
    using C = tc::Fwd<DP>;
    err = set_smem(tc::flash_fwd_wgmma<DP>, C::SMEM);
    if (err != 0) return err;
    const int nq = (p.S + C::BM - 1) / C::BM;
    tc::flash_fwd_wgmma<DP><<<dim3(nq, p.B * p.H), C::NT, C::SMEM, stream>>>(
        p);
  } else if (which == kDq) {
    using C = tc::Dq<DP>;
    err = set_smem(tc::flash_dq_wgmma<DP>, C::SMEM);
    if (err != 0) return err;
    const int nq = (p.S + C::BM - 1) / C::BM;
    tc::flash_dq_wgmma<DP><<<dim3(nq, p.B * p.H), C::NT, C::SMEM, stream>>>(
        p);
  } else {
    using C = tc::Dkv<DP>;
    err = set_smem(tc::flash_dkv_wgmma<DP>, C::SMEM);
    if (err != 0) return err;
    const int nk = (p.S + C::BN - 1) / C::BN;
    tc::flash_dkv_wgmma<DP>
        <<<dim3(nk, p.B * p.KV), C::NT, C::SMEM, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int dispatch_tc(Which which, const Params& p, int n_in,
                cudaStream_t stream) {
  // The copies move 16 bytes (8 bf16) at a time: every input's base and
  // (b, h, s) strides must keep that alignment.
  const void* in[] = {p.q, p.k, p.v, p.g};
  const Str* st[] = {&p.sq, &p.sk, &p.sv, &p.sg};
  for (int i = 0; i < n_in; ++i) {
    if (!aligned16(in[i]) || st[i]->b % 8 != 0 || st[i]->h % 8 != 0 ||
        st[i]->s % 8 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  if (p.D <= 64) return launch_tc<64>(which, p, stream);
  if (p.D <= 96) return launch_tc<96>(which, p, stream);
  return launch_tc<128>(which, p, stream);
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
  if (dtype == 0) return dispatch_d(which, p, s);
  if (dtype == 1) return dispatch_tc(which, p, which == kFwd ? 3 : 4, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every tensor is [B, H or KV, S, D] with a unit D stride; `strides` holds
// (b, h, s) element strides for each strided tensor in argument order.
// lse and delta are contiguous fp32 [B*H, S]; seg is [B, S] int32 or null.
// dtype: 0 = fp32, 1 = bf16.  bf16 runs on the tensor cores and needs
// 16-byte aligned inputs (cudaErrorMisalignedAddress otherwise).  Each
// call launches on `stream` and returns cudaGetLastError() (0 on success).

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

// The layout probe of the card test: one block over contiguous [64, 64]
// bf16 q, k, v; fp32 [64, 64] s and o.
extern "C" int dlr_wgmma_tile_probe(const void* q, const void* k,
                                    const void* v, float* s, float* o,
                                    void* stream) {
  tc::wgmma_tile_probe<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), s, o);
  return static_cast<int>(cudaGetLastError());
}
