// Flash attention for Hopper: the full-sequence kernel and the
// chunked-prefill kernel at per-row offsets, one templated tile loop.
//
// Replaces:
//   src/repro/kernels/flash_attention.py::flash_attention_pallas (:98)
//     — entry points flash_full_f32 / flash_full_bf16: a static q_offset;
//   src/repro/kernels/flash_attention.py::flash_attention_prefill_pallas
//     (:155) — entry points flash_prefill_f32 / flash_prefill_bf16: a per-row
//     offset read from q_offsets[b].
//
// Function: q (B, Hq, T, D), k and v (B, Hkv, S, D) → o (B, Hq, T, D).
// Query (b, t) sits at absolute position off + t, where off is q_offset
// (full) or q_offsets[b] (prefill); it sees key j iff j <= off + t
// (causal), j < kv_len, and with a window j > off + t - window.  GQA: query
// head h reads kv head h / (Hq / Hkv).  A row with no visible key returns 0.
// Every tensor is read and written through its strides (the last axis must
// be contiguous), so q, k and v are read as views of the qkv projection (or
// of the serving cache) and the output lands token-major for the out
// projection with no transpose.  fp32 or bf16 (q, k, v and o share one
// type); scores, softmax and P·V are fp32, with scale 1/sqrt(D).
//
// What bounds it on the H100.  Prefill (C ≤ 32 queries against S ≤ 512
// slots) is bytes-bound: 4·C·S·D FLOPs per head against reading the live
// prefix of each row's K/V.  The full-sequence kernel is bytes-bound at
// training shapes (B = 8, T = 256, D = 64: 6.3 MB against 0.6 GFLOP causal)
// and operations-bound from T ≈ 1k (T = 2048: 4.8 GFLOP causal, 1.9 MB);
// this first design runs on CUDA cores in fp32, far from either bound.
//
// Design: one block per (row b, query head, tile of BQ queries) — BQ = 16
// with 4 warps for prefill chunks, BQ = 64 with 8 warps for full sequences.
// Any head dim that is a multiple of 8 up to 256: the largest head dim DM
// is a template parameter that sizes each thread's accumulator slice, 128
// (every D ≤ 128, smollm-135m's 64 among them) or 256; at 256 both kernels
// take the prefill tile (BQ = 16 queries, 4 warps), so that a thread keeps
// 32 accumulator entries in registers.
// Tiles are issued last-first, so the longest causal rows start first.  An
// online softmax in fp32 (running max, sum and accumulator, as the TPU
// kernel keeps them in VMEM scratch) walks KV tiles of BKV keys only up to
// the tile's causal limit and from its window start, so dead tiles are never
// loaded (the TPU kernel's `live` predicate).  K/V tiles are staged in
// shared memory (K rows padded against bank conflicts), each warp owns whole
// query rows for the max/sum reductions, and each thread owns a fixed slice
// of the (BQ, D) accumulator in registers.  Tensor-core MMA (wgmma), TMA
// and GQA head packing are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int BKV = 32;       // keys per tile (one per lane in the softmax)
constexpr int DMAX = 256;     // largest head dim
constexpr float M_INIT = -1e30f;      // running-max start (TPU kernel's NEG_INF)
// (query rows, threads) per block
constexpr int PREFILL_BQ = 16, PREFILL_NT = 128;
constexpr int FULL_BQ = 64, FULL_NT = 256;
constexpr int WIDE_D = 128;   // head dims above it take the DM = 256 tiles

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long qb, qh, qt, kb, kh, ks, vb, vh, vs, ob, oh, ot;
};

// PER_ROW: the query offset is offs[b] (prefill) or the static q_offset.
// DM: the largest head dim D this instantiation takes.
template <typename T, int BQ, int NT, bool PER_ROW, int DM>
__global__ void __launch_bounds__(NT)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ offs,
            int q_offset, T* __restrict__ o, int Hq, int Hkv, int C, int D,
            Strides st, int causal, int window, int kv_len, float scale) {
  constexpr int EPT = BQ * DM / NT;   // accumulator entries per thread
  const int b = blockIdx.x / Hq, h = blockIdx.x - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // last tile first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = PER_ROW ? offs[b] : q_offset;
  const int rows = min(BQ, C - t0);

  extern __shared__ float sm[];
  float* qs = sm;                     // (BQ, D)      scaled queries
  float* ks = qs + BQ * D;            // (BKV, D + 1) key tile
  float* vs = ks + BKV * (D + 1);     // (BKV, D)     value tile
  float* ps = vs + BKV * D;           // (BQ, BKV)    scores → probabilities
  float* mrow = ps + BQ * BKV;        // (BQ,)        running max
  float* lrow = mrow + BQ;            // (BQ,)        running sum
  float* arow = lrow + BQ;            // (BQ,)        this tile's rescale

  const T* qp = q + b * st.qb + h * st.qh;
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int t = idx / D, d = idx - t * D;
    qs[idx] = t < rows ? to_f(qp[(t0 + t) * st.qt + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    mrow[tid] = M_INIT;
    lrow[tid] = 0.f;
  }
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;

  // keys any query of this tile can see
  const int q_lo = off + t0, q_hi = off + t0 + rows - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;

  for (int j0 = (k_begin / BKV) * BKV; j0 < k_end; j0 += BKV) {
    __syncthreads();  // queries ready; the previous tile fully consumed
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int j = idx / D, d = idx - j * D;
      const bool in = j0 + j < k_end;
      ks[j * (D + 1) + d] = in ? to_f(kp[(j0 + j) * st.ks + d]) : 0.f;
      vs[j * D + d] = in ? to_f(vp[(j0 + j) * st.vs + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * BKV; idx += NT) {
      const int t = idx / BKV, j = idx - t * BKV;
      const int qpos = off + t0 + t, kpos = j0 + j;
      bool live = t < rows && kpos < kv_len;
      if (causal) live = live && kpos <= qpos;
      if (window > 0) live = live && kpos > qpos - window;
      float s = -INFINITY;
      if (live) {
        float a = 0.f;
        for (int d = 0; d < D; ++d)
          a = fmaf(qs[t * D + d], ks[j * (D + 1) + d], a);
        s = a;
      }
      ps[idx] = s;
    }
    __syncthreads();
    // online softmax: warp w owns rows w, w + NT/32, ...; lane = key
    for (int t = warp; t < BQ; t += NT / 32) {
      const float s = ps[t * BKV + lane];
      float mx = s;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_prev = mrow[t];
      const float m_new = fmaxf(m_prev, mx);
      const float pe = expf(s - m_new);   // masked: exp(-inf) = 0
      float sum = pe;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      ps[t * BKV + lane] = pe;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        lrow[t] = lrow[t] * alpha + sum;
        mrow[t] = m_new;
        arow[t] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int idx = tid + e * NT;
      if (idx < BQ * D) {
        const int t = idx / D, d = idx - t * D;
        float a = acc[e] * arow[t];
        for (int j = 0; j < BKV; ++j) a = fmaf(ps[t * BKV + j], vs[j * D + d], a);
        acc[e] = a;
      }
    }
  }
  __syncthreads();  // lrow final
  T* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = tid + e * NT;
    if (idx < BQ * D) {
      const int t = idx / D, d = idx - t * D;
      if (t < rows) {
        const float l = lrow[t];
        put(op + (t0 + t) * st.ot + d, l > 0.f ? acc[e] / l : 0.f);
      }
    }
  }
}

Strides make_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <typename T, int BQ, int NT, bool PER_ROW, int DM>
int launch_dm(const void* q, const void* k, const void* v, const void* offs,
              int q_offset, void* o, int B, int Hq, int Hkv, int C, int D,
              const long long* strides, int causal, int window, int kv_len,
              void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > DM ||
      D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)BQ * D + (size_t)BKV * (D + 1) +
                                       (size_t)BKV * D + BQ * BKV + 3 * BQ);
  auto kernel = attn_kernel<T, BQ, NT, PER_ROW, DM>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * Hq, (C + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)offs, q_offset,
      (T*)o, Hq, Hkv, C, D, make_strides(strides), causal, window, kv_len,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// D ≤ 128: the tiles every smollm-135m launch takes; 128 < D ≤ 256: the
// same kernel with a 256-wide accumulator slice on the prefill tile (16
// query rows, 4 warps) for both (full-sequence tiles of 32 rows × 8 warps
// and 16 rows × 8 warps spilled 60 and 4 bytes)
template <typename T, int BQ, int NT, bool PER_ROW>
int launch(const void* q, const void* k, const void* v, const void* offs,
           int q_offset, void* o, int B, int Hq, int Hkv, int C, int D,
           const long long* strides, int causal, int window, int kv_len,
           void* stream) {
  if (D <= WIDE_D)
    return launch_dm<T, BQ, NT, PER_ROW, WIDE_D>(
        q, k, v, offs, q_offset, o, B, Hq, Hkv, C, D, strides, causal,
        window, kv_len, stream);
  return launch_dm<T, PREFILL_BQ, PREFILL_NT, PER_ROW, DMAX>(
      q, k, v, offs, q_offset, o, B, Hq, Hkv, C, D, strides, causal, window,
      kv_len, stream);
}

}  // namespace

extern "C" {

int flash_prefill_f32(const void* q, const void* k, const void* v,
                      const void* offs, void* o, int B, int Hq, int Hkv, int C,
                      int D, const long long* strides, int causal, int window,
                      int kv_len, void* stream) {
  return launch<float, PREFILL_BQ, PREFILL_NT, true>(
      q, k, v, offs, 0, o, B, Hq, Hkv, C, D, strides, causal, window, kv_len,
      stream);
}

int flash_prefill_bf16(const void* q, const void* k, const void* v,
                       const void* offs, void* o, int B, int Hq, int Hkv,
                       int C, int D, const long long* strides, int causal,
                       int window, int kv_len, void* stream) {
  return launch<__nv_bfloat16, PREFILL_BQ, PREFILL_NT, true>(
      q, k, v, offs, 0, o, B, Hq, Hkv, C, D, strides, causal, window, kv_len,
      stream);
}

int flash_full_f32(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int T, int D,
                   const long long* strides, int causal, int window,
                   int q_offset, int kv_len, void* stream) {
  return launch<float, FULL_BQ, FULL_NT, false>(
      q, k, v, nullptr, q_offset, o, B, Hq, Hkv, T, D, strides, causal,
      window, kv_len, stream);
}

int flash_full_bf16(const void* q, const void* k, const void* v, void* o,
                    int B, int Hq, int Hkv, int T, int D,
                    const long long* strides, int causal, int window,
                    int q_offset, int kv_len, void* stream) {
  return launch<__nv_bfloat16, FULL_BQ, FULL_NT, false>(
      q, k, v, nullptr, q_offset, o, B, Hq, Hkv, T, D, strides, causal,
      window, kv_len, stream);
}

}  // extern "C"
