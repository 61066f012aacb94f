// Fused BLAST matmul (paper Alg. 1) for Hopper, float factors, plain and
// grouped.
//
// Replaces: src/repro/kernels/blast_matmul.py::blast_matmul_pallas (:285)
// and ::blast_matmul_grouped_pallas (:324).
//
// Function: x (T, n), U (G, b, p, r), S (G, b, b, r), V (G, b, q, r) →
// y (G, T, m) with m = b·p, n = b·q, and for each factor set g
//     z_j = x_j V_j,   w_i = Σ_j s_ij ⊙ z_j,   y_i = w_i U_iᵀ.
// x and the factors are fp32 or bf16 (one type for all four); every sum is
// taken in fp32 and y is written in x's type.  G = 1 is the plain kernel.
//
// What bounds it on the H100: at decode (T = slot count ≤ 8) the factors
// are the only sizeable bytes — (m + n + b²)·r values per linear, read once
// from HBM — so the bound is bytes over 3.35 TB/s.  At prefill (T = slots ×
// chunk = 256) the Alg.-1 work 2·T·((m + n)·r + b²·r) FLOPs sits far below
// the bf16 tensor-core ridge too; the kernel's own cost is its stage-1
// recompute (below), which runs on the CUDA cores.
//
// Design: the TPU kernel carries the y accumulator across its sequential
// (r-tile, i) grid axes.  Hopper blocks run in no order, so that carry
// becomes a loop inside one block: one block per (output block i, T tile,
// g), looping over r tiles of RT ranks.  Per r tile it recomputes stage 1
// (z_j for every j) into shared memory, reduces stage 2 into shared memory
// and accumulates y_i in an fp32 shared accumulator the block owns.  Z and
// W never touch HBM, no cross-block reduction is needed and the result is
// deterministic; the price is b-fold stage-1 recompute.  p, q and r are not
// assumed to be powers of two: every loop runs to its own bound, the T edge
// is masked and r must be a multiple of RT (the wrapper zero-pads, which is
// exact).  wgmma/TMA tiling and a split-r design are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 8;          // token rows per block
constexpr int RT = 16;         // ranks per r tile
constexpr int NT = 256;        // threads per block
constexpr int UPAD = RT + 1;   // padded row stride of the U tile in smem

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
blast_kernel(const T* __restrict__ x, const T* __restrict__ U,
             const T* __restrict__ S, const T* __restrict__ V,
             T* __restrict__ y, int T_rows, int b, int p, int q, int r) {
  const int i = blockIdx.x;          // output block
  const int t0 = blockIdx.y * BT;    // first token row of this tile
  const int g = blockIdx.z;          // factor set
  const int n = b * q, m = b * p;
  const int tid = threadIdx.x;
  const int rows = min(BT, T_rows - t0);

  const T* Ui = U + ((size_t)g * b + i) * p * r;   // U[g, i]: (p, r)
  const T* Si = S + ((size_t)g * b + i) * b * r;   // S[g, i]: (b, r)
  const T* Vg = V + (size_t)g * b * q * r;         // V[g]:    (b, q, r)
  T* yg = y + (size_t)g * T_rows * m;              // y[g]:    (T, m)

  extern __shared__ float smem[];
  float* xs = smem;                 // (BT, n)      x tile
  float* zs = xs + BT * n;          // (b, BT, RT)  stage-1 tile
  float* ws = zs + b * BT * RT;     // (BT, RT)     stage-2 tile
  float* us = ws + BT * RT;         // (p, UPAD)    U_i r tile
  float* ys = us + p * UPAD;        // (BT, p)      fp32 accumulator

  for (int idx = tid; idx < BT * n; idx += NT) {
    const int t = idx / n, c = idx - t * n;
    xs[idx] = t < rows ? to_f(x[(size_t)(t0 + t) * n + c]) : 0.f;
  }
  for (int idx = tid; idx < BT * p; idx += NT) ys[idx] = 0.f;

  for (int r0 = 0; r0 < r; r0 += RT) {
    __syncthreads();  // x tile ready; the previous r tile fully consumed
    for (int idx = tid; idx < p * RT; idx += NT) {
      const int pp = idx / RT, rr = idx - pp * RT;
      us[pp * UPAD + rr] = to_f(Ui[(size_t)pp * r + r0 + rr]);
    }
    // stage 1: z_j[t, rr] = Σ_k x[t, j·q + k] · V[j, k, r0 + rr]
    for (int item = tid; item < b * RT; item += NT) {
      const int j = item / RT, rr = item - j * RT;
      float acc[BT];
#pragma unroll
      for (int t = 0; t < BT; ++t) acc[t] = 0.f;
      const T* vj = Vg + (size_t)j * q * r + r0 + rr;
      const float* xj = xs + j * q;
      for (int k = 0; k < q; ++k) {
        const float v = to_f(vj[(size_t)k * r]);
#pragma unroll
        for (int t = 0; t < BT; ++t) acc[t] = fmaf(xj[t * n + k], v, acc[t]);
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) zs[(j * BT + t) * RT + rr] = acc[t];
    }
    __syncthreads();
    // stage 2: w[t, rr] = Σ_j s_ij[r0 + rr] · z_j[t, rr]
    for (int item = tid; item < BT * RT; item += NT) {
      const int t = item / RT, rr = item - t * RT;
      float w = 0.f;
      for (int j = 0; j < b; ++j)
        w = fmaf(to_f(Si[(size_t)j * r + r0 + rr]),
                 zs[(j * BT + t) * RT + rr], w);
      ws[item] = w;
    }
    __syncthreads();
    // stage 3: y_i[t, pp] += Σ_rr w[t, rr] · U_i[pp, r0 + rr]
    for (int item = tid; item < BT * p; item += NT) {
      const int t = item / p, pp = item - t * p;
      float a = ys[item];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
        a = fmaf(ws[t * RT + rr], us[pp * UPAD + rr], a);
      ys[item] = a;
    }
  }
  // each thread stores the accumulator entries it alone updated
  for (int item = tid; item < BT * p; item += NT) {
    const int t = item / p, pp = item - t * p;
    if (t < rows) put(yg + (size_t)(t0 + t) * m + (size_t)i * p + pp, ys[item]);
  }
}

template <typename T>
int launch(const void* x, const void* U, const void* S, const void* V,
           void* y, int T_rows, int G, int b, int p, int q, int r,
           void* stream) {
  if (T_rows <= 0 || G <= 0 || b <= 0 || p <= 0 || q <= 0 || r <= 0 ||
      r % RT != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)BT * b * q + (size_t)b * BT * RT + BT * RT +
                       (size_t)p * UPAD + (size_t)BT * p);
  static size_t opted_in = 48 * 1024;   // per instantiation
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        blast_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid(b, (T_rows + BT - 1) / BT, G);
  blast_kernel<T><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)U, (const T*)S, (const T*)V, (T*)y, T_rows, b,
      p, q, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int blast_matmul_tile_t() { return BT; }
int blast_matmul_tile_r() { return RT; }

int blast_matmul_f32(const void* x, const void* U, const void* S,
                     const void* V, void* y, int T_rows, int G, int b, int p,
                     int q, int r, void* stream) {
  return launch<float>(x, U, S, V, y, T_rows, G, b, p, q, r, stream);
}

int blast_matmul_bf16(const void* x, const void* U, const void* S,
                      const void* V, void* y, int T_rows, int G, int b, int p,
                      int q, int r, void* stream) {
  return launch<__nv_bfloat16>(x, U, S, V, y, T_rows, G, b, p, q, r, stream);
}

}  // extern "C"
