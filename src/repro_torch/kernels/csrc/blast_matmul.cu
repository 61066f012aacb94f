// Fused BLAST matmul (paper Alg. 1) for Hopper: float factors, int8 or
// nibble-packed int4 factor codes with per-block scales, and int8 or int4
// factors with per-token int8 activation codes (W8A8, W4A8); each plain and
// grouped.
//
// Replaces (src/repro/kernels/blast_matmul.py):
//   float:  blast_matmul_pallas (:285), blast_matmul_grouped_pallas (:324)
//   int8:   blast_matmul_q_pallas (:369), blast_matmul_grouped_q_pallas (:475)
//   int4:   blast_matmul_q4_pallas (:420), blast_matmul_grouped_q4_pallas
//           (:528)
//   W8A8:   blast_matmul_w8a8_pallas (:633, body _act_call :592 /
//           _kernel_qa :254), blast_matmul_grouped_w8a8_pallas (:726,
//           _grouped_act_call :683)
//   W4A8:   blast_matmul_w4a8_pallas (:660, _act_call :592 packed),
//           blast_matmul_grouped_w4a8_pallas (:748, _grouped_act_call :683)
//
// Function: x (T, n), U (G, b, p, r), S (G, b, b, r), V (G, b, q, r) →
// y (G, T, m) with m = b·p, n = b·q, and for each factor set g
//     z_j = x_j V_j,   w_i = Σ_j s_ij ⊙ z_j,   y_i = w_i U_iᵀ.
// Float: x and the factors are fp32 or bf16 (one type for all four).
// int8 (as the TPU kernels' _quant_loaders): U/S/V are int8 codes with fp32
// scales su (G, b), ss (G, b, b), sv (G, b); codes are cast in-register,
// z_j is scaled once by sv[g, j], stage 2 uses code(s_ij)·ss[g, i, j], and
// the block's y accumulator is scaled once by su[g, i] before the store
// (su is constant over the output block, so that is exact).  x is fp32 or
// bf16 and y has x's type.
// int4: as int8, but U/S/V rows are r/2 bytes, two codes in [-7, 7] per
// byte (byte k holds logical rank 2k in its low nibble and 2k+1 in its
// high nibble, the quant/qarray.py layout).  Each load reads byte k >> 1
// and sign-extends nibble k & 1 in-register, so the kernel walks the
// logical rank order directly.  (The TPU kernel unpacks each tile into
// plane order [low | high] instead; both are exact, because stages 2–3
// reduce over r and any rank permutation shared by U, S and V leaves the
// sum unchanged up to fp32 summation order.)
// W8A8 / W4A8 (as _quant_act_loaders): x arrives as int8 per-token codes xq
// with fp32 scales sx (T, 1); stage 1 is an int32 contraction of int8
// codes against int8 (or sign-extended int4) factor codes, dequantized once
// by sx[t]·sv[g, j]; stages 2–3 as int8.  y is fp32 or bf16 (the layer
// input's type, chosen by the caller).
// Every float sum is taken in fp32.  G = 1 is the plain kernel.
//
// What bounds it on the H100: at decode (T = slot count ≤ 8) the factors
// are the only sizeable bytes — (m + n + b²)·r values per linear, read once
// from HBM (1 byte each for int8 codes, 0.5 byte for int4 codes, plus
// (2b + b²)·4 bytes of scales) — so the bound is bytes over 3.35 TB/s, at
// both T = 8 and T = 256 (the Alg.-1 work 2·T·((m + n)·r + b²·r)
// operations sits far below the tensor-core ridge).  The kernel's own cost
// is its stage-1 recompute (below), which runs on the CUDA cores.
//
// Design: the TPU kernel carries the y accumulator across its sequential
// (r-tile, i) grid axes.  Hopper blocks run in no order, so that carry
// becomes a loop inside one block: one block per (output block i, T tile,
// g), looping over r tiles of RT ranks.  Per r tile it recomputes stage 1
// (z_j for every j) into shared memory, reduces stage 2 into shared memory
// and accumulates y_i in an fp32 shared accumulator the block owns.  Z and
// W never touch HBM, no cross-block reduction is needed and the result is
// deterministic; the price is b-fold stage-1 recompute.  Against the bytes
// bound, the quantized variants read their factors as 1-byte or half-byte
// codes (a half or a quarter of bf16) and apply every scale to a stage
// output, never to a weight tile.  p, q and r are not assumed to be powers
// of two: every loop runs to its own bound, the T edge is masked and r
// (logical ranks) must be a multiple of RT (the wrapper zero-pads, which is
// exact: zero bytes are zero codes).  One template covers all variants, as
// the TPU kernels share _stages and differ in loaders and scalers;
// wgmma/TMA tiling, s8 mma.sync, lop3/prmt nibble unpacking and a split-r
// design are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BT = 8;          // token rows per block
constexpr int RT = 16;         // ranks per r tile
constexpr int NT = 256;        // threads per block
constexpr int UPAD = RT + 1;   // padded row stride of the U tile in smem

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(int v) { return (float)v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The factor value at a logical rank: itself for unpacked types; for packed
// int4 (F = uint8_t, the byte holding the rank) the low nibble (hi = 0) or
// the high nibble (hi = 1), sign-extended.
template <typename F>
__device__ __forceinline__ F code(F v, int) { return v; }
__device__ __forceinline__ int code(uint8_t v, int hi) {
  const int nib = hi ? v >> 4 : v & 0xF;
  return (nib ^ 8) - 8;
}

// X: activation type (float, bf16, or int8 codes); F: factor type (X for
// the float kernels, int8 codes, or uint8_t for nibble-packed int4 codes);
// O: output type.
template <typename X, typename F, typename O>
__global__ void __launch_bounds__(NT)
blast_kernel(const X* __restrict__ x, const float* __restrict__ sx,
             const F* __restrict__ U, const F* __restrict__ S,
             const F* __restrict__ V, const float* __restrict__ su,
             const float* __restrict__ ss, const float* __restrict__ sv,
             O* __restrict__ y, int T_rows, int b, int p, int q, int r) {
  constexpr bool PACKED = std::is_same<F, uint8_t>::value;  // int4 pairs
  constexpr bool QUANT = std::is_same<F, int8_t>::value || PACKED;  // codes
  constexpr bool A8 = std::is_same<X, int8_t>::value;     // W8A8 / W4A8
  constexpr int SH = PACKED ? 1 : 0;  // logical rank → element of F: k >> SH
  static_assert(QUANT || !A8, "int8 activations need integer factors");
  using Acc = typename std::conditional<A8, int, float>::type;

  const int i = blockIdx.x;          // output block
  const int t0 = blockIdx.y * BT;    // first token row of this tile
  const int g = blockIdx.z;          // factor set
  const int n = b * q, m = b * p;
  const int tid = threadIdx.x;
  const int rows = min(BT, T_rows - t0);
  const int rs = r >> SH;                // row length of a factor, in F

  const F* Ui = U + ((size_t)g * b + i) * p * rs;  // U[g, i]: (p, r)
  const F* Si = S + ((size_t)g * b + i) * b * rs;  // S[g, i]: (b, r)
  const F* Vg = V + (size_t)g * b * q * rs;        // V[g]:    (b, q, r)
  O* yg = y + (size_t)g * T_rows * m;              // y[g]:    (T, m)

  extern __shared__ float smem[];
  Acc* xs = reinterpret_cast<Acc*>(smem);  // (BT, n)  x tile (A8: codes)
  float* zs = smem + BT * n;        // (b, BT, RT)  stage-1 tile
  float* ws = zs + b * BT * RT;     // (BT, RT)     stage-2 tile
  float* us = ws + BT * RT;         // (p, UPAD)    U_i r tile
  float* ys = us + p * UPAD;        // (BT, p)      fp32 accumulator
  float* sxs = ys + BT * p;         // (BT,)        A8: token scales

  for (int idx = tid; idx < BT * n; idx += NT) {
    const int t = idx / n, c = idx - t * n;
    if constexpr (A8)
      xs[idx] = t < rows ? (int)x[(size_t)(t0 + t) * n + c] : 0;
    else
      xs[idx] = t < rows ? to_f(x[(size_t)(t0 + t) * n + c]) : 0.f;
  }
  if constexpr (A8)
    for (int t = tid; t < BT; t += NT) sxs[t] = t < rows ? sx[t0 + t] : 0.f;
  for (int idx = tid; idx < BT * p; idx += NT) ys[idx] = 0.f;

  for (int r0 = 0; r0 < r; r0 += RT) {
    __syncthreads();  // x tile ready; the previous r tile fully consumed
    for (int idx = tid; idx < p * RT; idx += NT) {
      const int pp = idx / RT, rr = idx - pp * RT;
      us[pp * UPAD + rr] =
          to_f(code(Ui[(size_t)pp * rs + ((r0 + rr) >> SH)], rr & 1));
    }
    // stage 1: z_j[t, rr] = Σ_k x[t, j·q + k] · V[j, k, r0 + rr]
    for (int item = tid; item < b * RT; item += NT) {
      const int j = item / RT, rr = item - j * RT;
      Acc acc[BT];
#pragma unroll
      for (int t = 0; t < BT; ++t) acc[t] = 0;
      const F* vj = Vg + (size_t)j * q * rs + ((r0 + rr) >> SH);
      const int hi = rr & 1;           // r0 is even: the nibble of r0 + rr
      const Acc* xj = xs + j * q;
      for (int k = 0; k < q; ++k) {
        if constexpr (A8) {
          const int v = code(vj[(size_t)k * rs], hi);
#pragma unroll
          for (int t = 0; t < BT; ++t) acc[t] += xj[t * n + k] * v;
        } else {
          const float v = to_f(code(vj[(size_t)k * rs], hi));
#pragma unroll
          for (int t = 0; t < BT; ++t) acc[t] = fmaf(xj[t * n + k], v, acc[t]);
        }
      }
      if constexpr (A8) {            // dequantize once: z · (sx_t · sv_j)
        const float svj = sv[(size_t)g * b + j];
#pragma unroll
        for (int t = 0; t < BT; ++t)
          zs[(j * BT + t) * RT + rr] = (float)acc[t] * (sxs[t] * svj);
      } else if constexpr (QUANT) {  // z_j · sv_j
        const float svj = sv[(size_t)g * b + j];
#pragma unroll
        for (int t = 0; t < BT; ++t) zs[(j * BT + t) * RT + rr] = acc[t] * svj;
      } else {
#pragma unroll
        for (int t = 0; t < BT; ++t) zs[(j * BT + t) * RT + rr] = acc[t];
      }
    }
    __syncthreads();
    // stage 2: w[t, rr] = Σ_j s_ij[r0 + rr] · z_j[t, rr]
    for (int item = tid; item < BT * RT; item += NT) {
      const int t = item / RT, rr = item - t * RT;
      float w = 0.f;
      for (int j = 0; j < b; ++j) {
        float s =
            to_f(code(Si[(size_t)j * rs + ((r0 + rr) >> SH)], rr & 1));
        if constexpr (QUANT) s *= ss[((size_t)g * b + i) * b + j];
        w = fmaf(s, zs[(j * BT + t) * RT + rr], w);
      }
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
  float sui = 1.f;
  if constexpr (QUANT) sui = su[(size_t)g * b + i];
  for (int item = tid; item < BT * p; item += NT) {
    const int t = item / p, pp = item - t * p;
    if (t < rows) {
      if constexpr (QUANT)
        put(yg + (size_t)(t0 + t) * m + (size_t)i * p + pp, ys[item] * sui);
      else
        put(yg + (size_t)(t0 + t) * m + (size_t)i * p + pp, ys[item]);
    }
  }
}

template <typename X, typename F, typename O>
int launch(const void* x, const void* sx, const void* U, const void* S,
           const void* V, const void* su, const void* ss, const void* sv,
           void* y, int T_rows, int G, int b, int p, int q, int r,
           void* stream) {
  constexpr bool A8 = std::is_same<X, int8_t>::value;
  if (T_rows <= 0 || G <= 0 || b <= 0 || p <= 0 || q <= 0 || r <= 0 ||
      r % RT != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)BT * b * q + (size_t)b * BT * RT + BT * RT +
                       (size_t)p * UPAD + (size_t)BT * p + (A8 ? BT : 0));
  static size_t opted_in = 48 * 1024;   // per instantiation
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        blast_kernel<X, F, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid(b, (T_rows + BT - 1) / BT, G);
  blast_kernel<X, F, O><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const X*)x, (const float*)sx, (const F*)U, (const F*)S, (const F*)V,
      (const float*)su, (const float*)ss, (const float*)sv, (O*)y, T_rows, b,
      p, q, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int blast_matmul_tile_t() { return BT; }
int blast_matmul_tile_r() { return RT; }

// float factors: x, U, S, V and y of one type
int blast_matmul_f32(const void* x, const void* U, const void* S,
                     const void* V, void* y, int T_rows, int G, int b, int p,
                     int q, int r, void* stream) {
  return launch<float, float, float>(x, nullptr, U, S, V, nullptr, nullptr,
                                     nullptr, y, T_rows, G, b, p, q, r,
                                     stream);
}

int blast_matmul_bf16(const void* x, const void* U, const void* S,
                      const void* V, void* y, int T_rows, int G, int b, int p,
                      int q, int r, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
      x, nullptr, U, S, V, nullptr, nullptr, nullptr, y, T_rows, G, b, p, q,
      r, stream);
}

// int8 factor codes, float x; y has x's type
int blast_matmul_q_f32(const void* x, const void* U, const void* S,
                       const void* V, const void* su, const void* ss,
                       const void* sv, void* y, int T_rows, int G, int b,
                       int p, int q, int r, void* stream) {
  return launch<float, int8_t, float>(x, nullptr, U, S, V, su, ss, sv, y,
                                      T_rows, G, b, p, q, r, stream);
}

int blast_matmul_q_bf16(const void* x, const void* U, const void* S,
                        const void* V, const void* su, const void* ss,
                        const void* sv, void* y, int T_rows, int G, int b,
                        int p, int q, int r, void* stream) {
  return launch<__nv_bfloat16, int8_t, __nv_bfloat16>(
      x, nullptr, U, S, V, su, ss, sv, y, T_rows, G, b, p, q, r, stream);
}

// int4 factor codes, nibble-packed (uint8, r/2 bytes per row; r counts
// logical ranks), float x; y has x's type
int blast_matmul_q4_f32(const void* x, const void* U, const void* S,
                        const void* V, const void* su, const void* ss,
                        const void* sv, void* y, int T_rows, int G, int b,
                        int p, int q, int r, void* stream) {
  return launch<float, uint8_t, float>(x, nullptr, U, S, V, su, ss, sv, y,
                                       T_rows, G, b, p, q, r, stream);
}

int blast_matmul_q4_bf16(const void* x, const void* U, const void* S,
                         const void* V, const void* su, const void* ss,
                         const void* sv, void* y, int T_rows, int G, int b,
                         int p, int q, int r, void* stream) {
  return launch<__nv_bfloat16, uint8_t, __nv_bfloat16>(
      x, nullptr, U, S, V, su, ss, sv, y, T_rows, G, b, p, q, r, stream);
}

// W8A8: int8 activation codes xq with fp32 scales sx; the suffix names y's
// type
int blast_matmul_w8a8_f32(const void* xq, const void* sx, const void* U,
                          const void* S, const void* V, const void* su,
                          const void* ss, const void* sv, void* y, int T_rows,
                          int G, int b, int p, int q, int r, void* stream) {
  return launch<int8_t, int8_t, float>(xq, sx, U, S, V, su, ss, sv, y,
                                       T_rows, G, b, p, q, r, stream);
}

int blast_matmul_w8a8_bf16(const void* xq, const void* sx, const void* U,
                           const void* S, const void* V, const void* su,
                           const void* ss, const void* sv, void* y,
                           int T_rows, int G, int b, int p, int q, int r,
                           void* stream) {
  return launch<int8_t, int8_t, __nv_bfloat16>(xq, sx, U, S, V, su, ss, sv,
                                               y, T_rows, G, b, p, q, r,
                                               stream);
}

// W4A8: int8 activation codes xq with fp32 scales sx against nibble-packed
// int4 factor codes; the suffix names y's type
int blast_matmul_w4a8_f32(const void* xq, const void* sx, const void* U,
                          const void* S, const void* V, const void* su,
                          const void* ss, const void* sv, void* y, int T_rows,
                          int G, int b, int p, int q, int r, void* stream) {
  return launch<int8_t, uint8_t, float>(xq, sx, U, S, V, su, ss, sv, y,
                                        T_rows, G, b, p, q, r, stream);
}

int blast_matmul_w4a8_bf16(const void* xq, const void* sx, const void* U,
                           const void* S, const void* V, const void* su,
                           const void* ss, const void* sv, void* y,
                           int T_rows, int G, int b, int p, int q, int r,
                           void* stream) {
  return launch<int8_t, uint8_t, __nv_bfloat16>(xq, sx, U, S, V, su, ss, sv,
                                                y, T_rows, G, b, p, q, r,
                                                stream);
}

}  // extern "C"
