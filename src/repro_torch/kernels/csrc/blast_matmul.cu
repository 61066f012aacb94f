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
// operations sits far below the tensor-core ridge); at the training
// step's 2048 tokens it is still bytes (x, y and factors), about 2–3 µs.
// What bounds each design is its own overhead, not that bound.
//
// Two designs share this file.
//
// Float (fp32, bf16: B1, B2, and B1 as the backward's dx) —
// blast_tile_kernel.  The TPU kernel fills its z scratch once per (T tile,
// r tile), at i == 0, and reuses it for every output block; so does this
// one.  A block of 16 warps owns 16 token rows, factor set g, a range of r
// (a split) and a group of up to 16 output blocks (all b unless the plan
// groups them, or b > 16): per r tile of RT ranks it computes z_j for
// every j (warp j mod 16), w_i for its i, and adds w_i U_iᵀ into the fp32
// accumulator of y_i that warp i holds in registers across the whole r
// range — stage 1 runs once per (T tile, r tile, group), not once per
// output block.  Registers hold up to 96 columns of y_i: a wider p (or one
// whose tiles would not fit shared memory) is cut into column chunks, one
// block each, which repeat stage 1 (none at smollm-135m's shapes).  The x
// tile and the V, S and U r-tiles go through shared memory by cp.async
// (factor rows in 16-byte halves, two lanes to a row); each factor's next
// tile starts copying as soon as its buffer has been consumed, so the copy
// overlaps the other two stages; no inner loop reads device memory.  bf16: stages 1 and 3
// are mma.sync.m16n8k16 bf16 → fp32 with operands from shared memory by
// ldmatrix (V transposed), rows padded to 48 bytes so that an 8-row load
// hits 8 bank groups; q and p are zero-padded to 16 and 8 (exact).  Tokens
// sit on the m = 16 side; at T ≤ 8 half the fragment is unused rows,
// which decode does not notice: it is bound by the copies' latency, not by
// the tensor cores.
// w enters stage 3 as two bf16 parts, hi = bf16(w) and lo = bf16(w − hi),
// in two mma passes over the same U fragment: w rounded once to bf16 moved
// y past the 2e-2 check at entries near zero.
// fp32: the same tiling and fragment ownership with FFMA on the CUDA cores
// (RT = 8, so the tiles fit shared memory), every sum a sequential fp32
// FMA chain in the first design's order — no TF32.  Stage 2 (b² products
// per token and rank) is fp32 FFMA in both, 2 i × 2 t × 2 ranks a thread.
// The epilogue stages y through shared memory and stores whole rows.
// Where ⌈T/16⌉·G blocks would leave most of the 132 SMs idle (decode,
// prefill), the wrapper's plan (kernels/blast_matmul.py split_plan) splits
// r across blocks, and at decode also the output blocks into groups (a
// group copies only its own S and U rows); each r split writes its fp32
// partial to a workspace and blast_split_sum, launched as a programmatic
// dependent of the tile kernel (its launch overlaps, griddepcontrol.wait
// holds its reads), adds them in split order: the result is the same bit
// for bit from run to run (no atomics).  At 2048 tokens nothing is split.
// What bounds it: per r tile, the copies — every factor row gives 32
// bytes, so each warp's cp.async touches 16 rows and the load/store unit
// takes them row by row — then the three stages' latency chains and
// barriers; at decode, the fixed chain of launch, prologue, one tile,
// epilogue and the split sum.  x
// rows past T are left unset (every stage keeps token rows apart, and
// those rows of y are not stored); r must be a multiple of 16 (the wrapper
// zero-pads: exact).  Shared memory holds the x tile and the V r-tile of
// all b input blocks, which grow with n = b·q: n up to 2,048 at b = 16
// (1,536 at b = 32) fits, in fp32 and bf16; the first design held n up to
// about 7,000 (it kept no V tile).  The factor loader is a template
// parameter (CopyRow for float factors), so a quantized loader can reuse
// the tiling.  TMA (one instruction per tile instead of a row per lane
// pair), a tile-major factor layout, wgmma and warp specialisation are
// later work.
//
// Quantized (B5–B12) — blast_kernel, the first design, unchanged: the TPU
// kernel carries the y accumulator across its sequential (r-tile, i) grid
// axes; Hopper blocks run in no order, so that carry becomes a loop inside
// one block: one block per (output block i, 8-token tile, g), looping over
// r tiles of RT ranks.  Per r tile it recomputes stage 1 (z_j for every j)
// into shared memory, reading V straight from device memory, reduces stage
// 2 into shared memory and accumulates y_i in an fp32 shared accumulator
// the block owns.  Z and W never touch HBM and the result is deterministic;
// the price is b-fold stage-1 recompute on the CUDA cores, which bounds it.
// Against the bytes bound, the quantized variants read their factors as
// 1-byte or half-byte codes and apply every scale to a stage output, never
// to a weight tile.  p, q and r are not assumed to be powers of two: every
// loop runs to its own bound, the T edge is masked and r (logical ranks)
// must be a multiple of RT (the wrapper zero-pads, which is exact: zero
// bytes are zero codes).  One template covers the quantized variants, as
// the TPU kernels share _stages and differ in loaders and scalers; moving
// them onto the float kernel's tiling (a code loader each, s8 mma.sync for
// W8A8/W4A8) is the next work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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

// The quantized kernels (first design, see the note).  X: activation type
// (float, bf16, or int8 codes); F: factor type (int8 codes, or uint8_t for
// nibble-packed int4 codes); O: output type.
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
  static_assert(QUANT, "float factors run blast_tile_kernel");
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
      } else {                       // z_j · sv_j
        const float svj = sv[(size_t)g * b + j];
#pragma unroll
        for (int t = 0; t < BT; ++t) zs[(j * BT + t) * RT + rr] = acc[t] * svj;
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
        s *= ss[((size_t)g * b + i) * b + j];
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
  const float sui = su[(size_t)g * b + i];
  for (int item = tid; item < BT * p; item += NT) {
    const int t = item / p, pp = item - t * p;
    if (t < rows)
      put(yg + (size_t)(t0 + t) * m + (size_t)i * p + pp, ys[item] * sui);
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

// ---- the float kernel (B1, B2): blast_tile_kernel ------------------------

constexpr int FBT = 16;          // token rows per block: one m16 fragment
constexpr int FNW = 16;          // warps: warp j computes z_j, warp i owns y_i
constexpr int FNT = FNW * 32;    // threads per block
constexpr int FMAXB = FNW;       // output blocks per block: one warp each
constexpr int FRANKS = 16;       // rank granule of the padding and the splits
constexpr int FMAXP8 = 12;       // columns per block ≤ 96 (8-column fragments)
constexpr int SMEM_MAX = 232448; // shared memory one block may opt in to

// Per element type: RT ranks per r tile (one staged tile row is RT·sizeof
// = 32 bytes for both) and the shared-memory row strides of the V, U and w
// tiles, in elements.  bf16 pads each ldmatrix'd row to 48 bytes, so that
// 8 consecutive rows fall into 8 distinct bank groups; fp32 pads U and w,
// of which a warp reads 8 rows at once.
template <typename E> struct FTile;
template <> struct FTile<__nv_bfloat16> {
  static constexpr int RT = 16, VROW = 24, UROW = 24, WROW = 24;
};
template <> struct FTile<float> {
  static constexpr int RT = 8, VROW = 8, UROW = 12, WROW = 12;
};

// Byte offsets of the shared-memory regions (each a multiple of 16 bytes)
// of a block that owns up to nb output blocks and pc columns of each:
// x tile (FBT, b·qpad + pad: block j at column j·qpad), V r-tile (b·qpad
// rows), U r-tile (nb·pc rows), S r-tile (nb·b rows), z (b, FBT, RT) fp32,
// w (nb, FBT rows; bf16: hi parts, then lo parts).  The epilogue's fp32 y
// tile (FBT, nb·pc + 8) overlays them.
template <typename E> struct FLayout {
  int ldx, xs, vs, us, ss, zs, ws, bytes;
  __host__ __device__ FLayout(int b, int qpad, int nb, int pc) {
    using C = FTile<E>;
    constexpr int e = (int)sizeof(E);
    ldx = b * qpad + 16 / e;   // +16 bytes: 8 x rows in 8 bank groups
    int off = 0;
    xs = off; off += FBT * ldx * e;
    vs = off; off += b * qpad * C::VROW * e;
    us = off; off += nb * pc * C::UROW * e;
    ss = off; off += nb * b * C::RT * e;
    zs = off; off += b * FBT * C::RT * 4;
    ws = off; off += (e == 2 ? 2 : 1) * nb * FBT * C::WROW * e;
    const int ytile = FBT * (nb * pc + 8) * 4;
    bytes = off > ytile ? off : ytile;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}
// d += a·b, one m16n8k16 bf16 fragment product with fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent values as floats
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
// two adjacent w values into the w tile: fp32 as they are; bf16 as hi parts
// at p and lo parts (what rounding to bf16 left out) at p + lo
__device__ __forceinline__ void store_w(float* p, int, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_w(__nv_bfloat16* p, int lo, float a,
                                        float b) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = hi;
  *reinterpret_cast<__nv_bfloat162*>(p + lo) =
      __floats2bfloat162_rn(a - __low2float(hi), b - __high2float(hi));
}

// four adjacent outputs (8- or 16-byte aligned)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// Factor loader of the float kernel: half h of one tile row (RT ranks, 32
// bytes) from device memory into shared memory, asynchronously.  Adjacent
// lanes take the two halves of a row, so that a warp's copies touch 16
// rows (32-byte segments) and not 32.
struct CopyRow {
  template <typename E>
  static __device__ __forceinline__ void half(E* dst, const E* src, int h) {
    cp_async16(reinterpret_cast<char*>(dst) + 16 * h,
               reinterpret_cast<const char*>(src) + 16 * h);
  }
};

// One block: token rows [t0, t0 + 16) of factor set g, the ranks of one
// split ([lo, lo + rps) ∩ [0, r)), the output blocks of one group ([ib, ib
// + ipg) ∩ [0, b), ipg ≤ 16) and the columns of one chunk of each ([c0, c0
// + pc) ∩ [0, p), pc ≤ 96); blockIdx.y = (split · groups + group) · chunks
// + chunk.  Fragment ownership (m16n8 C layout, lane = 4·gr + tq): rows gr
// and gr + 8, columns 2·tq and 2·tq + 1 of each 8-column tile.  With one
// split the block writes its columns of y (E); with several, of its
// split's fp32 partial, and blast_split_sum adds the partials into y.
template <typename E, class Load, int P8>
__global__ void __launch_bounds__(FNT, 1)
blast_tile_kernel(const E* __restrict__ x, const E* __restrict__ U,
                  const E* __restrict__ S, const E* __restrict__ V,
                  E* __restrict__ y, float* __restrict__ part, int T_rows,
                  int b, int p, int q, int r, int rps, int ipg, int pc) {
  using C = FTile<E>;
  constexpr int RT = C::RT;
  constexpr bool BF = std::is_same<E, __nv_bfloat16>::value;
  const int groups = (b + ipg - 1) / ipg, chunks = (p + pc - 1) / pc;
  const int splits = gridDim.y / (groups * chunks);
  const int t0 = blockIdx.x * FBT, g = blockIdx.z;
  const int sg = blockIdx.y / chunks, chunk = blockIdx.y - sg * chunks;
  const int split = sg / groups, grp = sg - split * groups;
  const int lo = split * rps, hi = min(r, lo + rps);
  const int ib = grp * ipg, nb = min(b, ib + ipg) - ib;  // output blocks owned
  const int c0 = chunk * pc, pw = min(pc, p - c0);       // their columns
  const int qpad = (q + 15) / 16 * 16, p8 = (pw + 7) / 8, pr = 8 * p8;
  const int n = b * q, m = b * p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = (lane & 3) * 2;
  const int rows = min(FBT, T_rows - t0);
  const int nbl = min(ipg, b);   // output blocks the tiles hold room for
  const FLayout<E> L(b, qpad, nbl, pc);
  // a split launch's blast_split_sum may start now and wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(128) unsigned char tile_smem[];
  E* xs = reinterpret_cast<E*>(tile_smem + L.xs);
  E* vs = reinterpret_cast<E*>(tile_smem + L.vs);
  E* us = reinterpret_cast<E*>(tile_smem + L.us);
  E* ss = reinterpret_cast<E*>(tile_smem + L.ss);
  float* zs = reinterpret_cast<float*>(tile_smem + L.zs);
  E* ws = reinterpret_cast<E*>(tile_smem + L.ws);
  [[maybe_unused]] const int WLO = nbl * FBT * C::WROW;  // bf16: lo parts
  const E* Ug = U + (size_t)g * b * p * r;   // (b, p, r)
  const E* Sg = S + (size_t)g * b * b * r;   // (b, b, r)
  const E* Vg = V + (size_t)g * b * q * r;   // (b, q, r)

  // each r tile's copies: one commit group per factor, always committed
  // (empty past the range) so that the group counts stay fixed
  auto copy_v = [&](int r0) {
    if (r0 < hi)
      for (int idx = tid; idx < 2 * b * q; idx += FNT) {
        const int row = idx >> 1, j = row / q, k = row - j * q;
        Load::half(vs + (j * qpad + k) * C::VROW, Vg + (size_t)row * r + r0,
                   idx & 1);
      }
    cp_commit();
  };
  auto copy_s = [&](int r0) {   // rows s_i· of the owned i
    if (r0 < hi)
      for (int idx = tid; idx < 2 * nb * b; idx += FNT) {
        const int row = idx >> 1;
        Load::half(ss + row * RT, Sg + (size_t)(ib * b + row) * r + r0,
                   idx & 1);
      }
    cp_commit();
  };
  auto copy_u = [&](int r0) {   // the owned columns of the owned U_i
    if (r0 < hi)
      for (int idx = tid; idx < 2 * nb * pw; idx += FNT) {
        const int row = idx >> 1, il = row / pw, pp = row - il * pw;
        Load::half(us + (il * pc + pp) * C::UROW,
                   Ug + ((size_t)(ib + il) * p + c0 + pp) * r + r0, idx & 1);
      }
    cp_commit();
  };
  // Zeros first, before the copies fill the load/store pipe: the x pad
  // columns past q in each block, and the pad rows of the V and U tiles
  // (never copied into; two 16-byte stores each, a tile row is 32 bytes).
  E zero;
  put(&zero, 0.f);
  for (int idx = tid; idx < rows * b * (qpad - q); idx += FNT) {
    const int blk = idx / (qpad - q);     // (t, j) of this pad element
    const int t = blk / b, j = blk - t * b;
    xs[t * L.ldx + j * qpad + q + idx - blk * (qpad - q)] = zero;
  }
  for (int idx = tid; idx < 2 * b * (qpad - q); idx += FNT) {
    const int row = idx >> 1, j = row / (qpad - q);
    reinterpret_cast<uint4*>(vs + (j * qpad + q + row - j * (qpad - q)) *
                                      C::VROW)[idx & 1] = make_uint4(0, 0, 0, 0);
  }
  for (int idx = tid; idx < 2 * nb * (pr - pw); idx += FNT) {
    const int row = idx >> 1, il = row / (pr - pw);
    reinterpret_cast<uint4*>(us + (il * pc + pw + row - il * (pr - pw)) *
                                      C::UROW)[idx & 1] = make_uint4(0, 0, 0, 0);
  }

  // The x tile, in E, one padded block per j: copied asynchronously with
  // the first V tile in chunks of 16, 8 or 4 bytes (the largest that
  // divides a block's q·sizeof(E) bytes and x's alignment), else loaded
  // element by element.  Rows past T are left as they are: every stage
  // keeps token rows apart (mma rows, stage 2 per row) and those rows of y
  // are not stored.
  const int seg = q * (int)sizeof(E);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int xc = seg % 16 == 0 && xa % 16 == 0 ? 16
                 : seg % 8 == 0 && xa % 8 == 0 ? 8
                 : seg % 4 == 0 && xa % 4 == 0 ? 4 : 0;
  if (xc) {
    const int per = seg / xc;   // chunks per (t, j) segment
    for (int idx = tid; idx < rows * b * per; idx += FNT) {
      const int tj = idx / per, t = tj / b, j = tj - t * b;
      const int off = (idx - tj * per) * xc;
      char* dst = reinterpret_cast<char*>(xs + t * L.ldx + j * qpad) + off;
      const char* src =
          reinterpret_cast<const char*>(x + (size_t)(t0 + t) * n + j * q) +
          off;
      if (xc == 16)
        cp_async16(dst, src);
      else if (xc == 8)
        cp_async8(dst, src);
      else
        cp_async4(dst, src);
    }
  }
  copy_v(lo);   // commits the x copies with V(lo)
  copy_s(lo);
  copy_u(lo);
  if (!xc)
    for (int idx = tid; idx < rows * b * q; idx += FNT) {
      const int t = idx / n, c = idx - t * n, j = c / q;
      xs[t * L.ldx + j * qpad + c - j * q] = x[(size_t)(t0 + t) * n + c];
    }
  float acc[P8][4];
#pragma unroll
  for (int nt = 0; nt < P8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  cp_wait<2>();      // V(lo) landed; S(lo), U(lo) may be in flight
  __syncthreads();
  for (int r0 = lo; r0 < hi; r0 += RT) {
    // stage 1: z_j (16 × RT) = x_j (16 × q) · V_j (q × RT), warp j mod 16
    for (int j = warp; j < b; j += FNW) {
      float z[RT / 8][4];
#pragma unroll
      for (int nt = 0; nt < RT / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) z[nt][c] = 0.f;
      if constexpr (BF) {
        for (int kk = 0; kk < qpad; kk += 16) {
          uint32_t a[4], v[4];
          ldsm_x4(a, xs + (lane & 15) * L.ldx + j * qpad + kk + (lane >> 4) * 8);
          ldsm_x4_t(v, vs + (j * qpad + kk + (lane & 15)) * C::VROW +
                           (lane >> 4) * 8);
          mma_bf16(z[0], a, v[0], v[1]);
          mma_bf16(z[1], a, v[2], v[3]);
        }
      } else {
        const float* x0 = xs + gr * L.ldx + j * qpad;
        const float* x1 = x0 + 8 * L.ldx;
        const float* vj = vs + j * qpad * C::VROW + tq;
        for (int k = 0; k < q; ++k) {
          const float a0 = x0[k], a1 = x1[k];
          const float v0 = vj[k * C::VROW], v1 = vj[k * C::VROW + 1];
          z[0][0] = fmaf(a0, v0, z[0][0]);
          z[0][1] = fmaf(a0, v1, z[0][1]);
          z[0][2] = fmaf(a1, v0, z[0][2]);
          z[0][3] = fmaf(a1, v1, z[0][3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < RT / 8; ++nt) {
        float* z0 = zs + (j * FBT + gr) * RT + nt * 8 + tq;
        z0[0] = z[nt][0];
        z0[1] = z[nt][1];
        z0[8 * RT] = z[nt][2];
        z0[8 * RT + 1] = z[nt][3];
      }
    }
    cp_wait<1>();    // S(r0)
    __syncthreads(); // z ready, V tile free, S tile landed
    copy_v(r0 + RT);
    // stage 2: w_i[t, rr] = Σ_j s_ij[rr] · z_j[t, rr], fp32, j in order.  A
    // thread owns 2 i × 2 t × 2 adjacent ranks: per j, 2 S pairs (broadcast
    // over the warp's t lanes) and 2 z pairs for 8 FMAs.  Warps whose token
    // rows all lie past T skip (at decode, half of them).
    {
      constexpr int RP = RT / 2, TGL = 32 / RP, TGW = FBT / (2 * TGL);
      static_assert(2 * (FNW / TGW) >= FMAXB, "stage 2 covers every block");
      const int i0 = 2 * (warp / TGW), tw = warp % TGW;   // owned, from ib
      if (i0 < nb && tw * 2 * TGL < rows) {
        const int rr = 2 * (lane % RP);
        const int ta = tw * 2 * TGL + lane / RP, tb = ta + TGL;
        const int i1 = min(i0 + 1, nb - 1);   // past nb: computed, not stored
        float w[2][2][2];
#pragma unroll
        for (int c = 0; c < 8; ++c) w[c >> 2][(c >> 1) & 1][c & 1] = 0.f;
#pragma unroll 4
        for (int j = 0; j < b; ++j) {
          const float2 za = *reinterpret_cast<const float2*>(
              zs + (j * FBT + ta) * RT + rr);
          const float2 zb = *reinterpret_cast<const float2*>(
              zs + (j * FBT + tb) * RT + rr);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            float s0, s1;
            load2(ss + ((a ? i1 : i0) * b + j) * RT + rr, s0, s1);
            w[a][0][0] = fmaf(s0, za.x, w[a][0][0]);
            w[a][0][1] = fmaf(s1, za.y, w[a][0][1]);
            w[a][1][0] = fmaf(s0, zb.x, w[a][1][0]);
            w[a][1][1] = fmaf(s1, zb.y, w[a][1][1]);
          }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
          if (i0 + a < nb)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              store_w(ws + ((i0 + a) * FBT + (c ? tb : ta)) * C::WROW + rr,
                      WLO, w[a][c][0], w[a][c][1]);
      }
    }
    cp_wait<1>();    // U(r0)
    __syncthreads(); // w ready, S tile free, U tile landed
    copy_s(r0 + RT);
    // stage 3: y_i (16 × pw) += w_i (16 × RT) · U_iᵀ (RT × pw), warp i − ib
    if (warp < nb) {
      const int i = warp;   // from ib, as the U, S and w tiles count
      if constexpr (BF) {
        uint32_t a[4], lo4[4];
        const E* wi = ws + (i * FBT + (lane & 15)) * C::WROW + (lane >> 4) * 8;
        ldsm_x4(a, wi);
        ldsm_x4(lo4, wi + WLO);
#pragma unroll
        for (int nt = 0; nt < P8; ++nt)
          if (nt < p8) {
            uint32_t u[2];
            ldsm_x2(u, us + (i * pc + nt * 8 + (lane & 7)) * C::UROW +
                           ((lane >> 3) & 1) * 8);
            mma_bf16(acc[nt], a, u[0], u[1]);
            mma_bf16(acc[nt], lo4, u[0], u[1]);
          }
      } else {
        const float* w0 = ws + (i * FBT + gr) * C::WROW;
        const float* w1 = w0 + 8 * C::WROW;
#pragma unroll
        for (int nt = 0; nt < P8; ++nt)
          if (nt < p8) {
            const float* u0 = us + (i * pc + nt * 8 + tq) * C::UROW;
            const float* u1 = u0 + C::UROW;
#pragma unroll
            for (int rr = 0; rr < RT; ++rr) {
              acc[nt][0] = fmaf(w0[rr], u0[rr], acc[nt][0]);
              acc[nt][1] = fmaf(w0[rr], u1[rr], acc[nt][1]);
              acc[nt][2] = fmaf(w1[rr], u0[rr], acc[nt][2]);
              acc[nt][3] = fmaf(w1[rr], u1[rr], acc[nt][3]);
            }
          }
      }
    }
    cp_wait<1>();    // V(r0 + RT)
    __syncthreads(); // U and w tiles free, next V tile landed
    copy_u(r0 + RT);
  }
  cp_wait<0>();

  // epilogue: the fragments into an fp32 (16 × nb·pw) tile in shared
  // memory (rows padded by 8 floats), then rows of each owned block out, in
  // 16-byte stores where p allows: y (E), or with a split this split's fp32
  // partial
  const int wd = nb * pw, ldy = wd + 8;
  float* ys = reinterpret_cast<float*>(tile_smem);
  __syncthreads();   // every warp done with the tiles the y tile overlays
  if (warp < nb) {
#pragma unroll
    for (int nt = 0; nt < P8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // rows gr, gr + 8: columns pp, pp + 1
        const int t = gr + 8 * h, pp = nt * 8 + tq;
        float* yt = ys + t * ldy + warp * pw + pp;
        if (nt < p8 && pp < pw) {
          yt[0] = acc[nt][2 * h];
          if (pp + 1 < pw) yt[1] = acc[nt][2 * h + 1];
        }
      }
  }
  __syncthreads();
  // this tile's rows: column c of the y tile is column (ib + c / pw)·p + c0
  // + c mod pw of y (contiguous when the chunk is all of p)
  const size_t at0 = ((size_t)g * T_rows + t0) * m;
  float* pt = part + (size_t)split * gridDim.z * T_rows * m + at0;
  const int vw = p % 4 == 0 ? 4 : 1;   // pw too: c0 is a multiple of 8
  for (int e = tid; e < rows * wd / vw; e += FNT) {
    const int t = vw * e / wd, c = vw * e - t * wd, il = c / pw;
    const size_t at = (size_t)t * m + (ib + il) * p + c0 + c - il * pw;
    if (vw == 4) {
      const float4 v = *reinterpret_cast<const float4*>(ys + t * ldy + c);
      if (splits == 1)
        store4(y + at0 + at, v);
      else
        *reinterpret_cast<float4*>(pt + at) = v;
    } else if (splits == 1) {
      put(y + at0 + at, ys[t * ldy + c]);
    } else {
      pt[at] = ys[t * ldy + c];
    }
  }
}

// y = Σ_s part[s] over the splits of a split launch, added in index order
// (the same sum every run); all of a thread's split loads in flight at once
template <typename E>
__global__ void __launch_bounds__(256)
blast_split_sum(const float* __restrict__ part, E* __restrict__ y,
                size_t total, int splits) {
  constexpr int KS = 12;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  // launched early (programmatic dependent launch): wait until the tile
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (total % 4 == 0) {
    const float4* P = reinterpret_cast<const float4*>(part);
    for (size_t v = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         v < total / 4; v += stride) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k0 = 0; k0 < splits; k0 += KS) {
        float4 a[KS];
#pragma unroll
        for (int u = 0; u < KS; ++u)
          if (k0 + u < splits) a[u] = P[(k0 + u) * (total / 4) + v];
#pragma unroll
        for (int u = 0; u < KS; ++u)
          if (k0 + u < splits) {
            sum.x += a[u].x;
            sum.y += a[u].y;
            sum.z += a[u].z;
            sum.w += a[u].w;
          }
      }
      store4(y + 4 * v, sum);
    }
  } else {
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += stride) {
      float sum = 0.f;
      for (int k = 0; k < splits; ++k) sum += part[k * total + e];
      put(y + e, sum);
    }
  }
}

template <typename E, int P8>
int launch_tile(const E* x, const E* U, const E* S, const E* V, E* y,
                float* part, int T_rows, int G, int b, int p, int q, int r,
                int rps, int ipg, int pc, int splits, int smem,
                cudaStream_t stream) {
  static int opted_in = 48 * 1024;   // per instantiation
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        blast_tile_kernel<E, CopyRow, P8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid((T_rows + FBT - 1) / FBT,
                  splits * ((b + ipg - 1) / ipg) * ((p + pc - 1) / pc), G);
  blast_tile_kernel<E, CopyRow, P8><<<grid, FNT, smem, stream>>>(
      x, U, S, V, y, part, T_rows, b, p, q, r, rps, ipg, pc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t total = (size_t)G * T_rows * b * p;
  const size_t blocks = (total / 4 + 255) / 256;
  // programmatic dependent launch: the sum's launch overlaps the tile
  // kernel, and griddepcontrol.wait holds its reads until the tile kernel
  // is done
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min<size_t>(blocks, 1024));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, blast_split_sum<E>, (const float*)part,
                                 y, total, splits);
}

// x (T, n), U/S/V (G, b, ·, r) and y (G, T, m) of type E.  The grid is
// (⌈T/16⌉, splits of r (rps ranks each) × groups of ipg ≤ 16 output blocks
// × chunks of pc columns, G); pc is the widest multiple of 8, at most 96,
// whose tiles fit shared memory (at smollm-135m's shapes, all of p).  With
// rps < r (a split launch), part is an fp32 workspace (splits, G, T, m);
// unused (may be null) otherwise.  cudaErrorInvalidValue: a bad argument,
// or tiles that do not fit even at pc = 8 (x and V grow with n = b·q).
template <typename E>
int launch_float(const void* x, const void* U, const void* S, const void* V,
                 void* y, void* part, int T_rows, int G, int b, int p, int q,
                 int r, int rps, int ipg, void* stream) {
  if (T_rows <= 0 || G <= 0 || b <= 0 || p <= 0 || q <= 0 || r <= 0 ||
      r % FRANKS != 0 || rps <= 0 || rps % FRANKS != 0 || ipg <= 0 ||
      ipg > FMAXB)
    return (int)cudaErrorInvalidValue;
  const int splits = (r + rps - 1) / rps;
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const int qpad = (q + 15) / 16 * 16, nb = std::min(ipg, b);
  int pc = 8 * std::min((p + 7) / 8, FMAXP8);
  while (pc > 8 && FLayout<E>(b, qpad, nb, pc).bytes > SMEM_MAX) pc -= 8;
  const int smem = FLayout<E>(b, qpad, nb, pc).bytes;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto go = [&](auto p8c) {
    return launch_tile<E, decltype(p8c)::value>(
        (const E*)x, (const E*)U, (const E*)S, (const E*)V, (E*)y,
        (float*)part, T_rows, G, b, p, q, r, rps, ipg, pc, splits, smem,
        (cudaStream_t)stream);
  };
  if (pc <= 32) return go(std::integral_constant<int, 4>());
  if (pc <= 64) return go(std::integral_constant<int, 8>());
  return go(std::integral_constant<int, FMAXP8>());
}

}  // namespace

extern "C" {

// tiles of the quantized kernel, and of the float kernel (token rows per
// block; the rank granule of its padding and splits; output blocks per
// block, at most)
int blast_matmul_tile_t() { return BT; }
int blast_matmul_tile_r() { return RT; }
int blast_float_tile_t() { return FBT; }
int blast_float_tile_r() { return FRANKS; }
int blast_float_tile_b() { return FMAXB; }

// float factors (the float kernel): x, U, S, V and y of one type; part,
// rps (ranks per split) and ipg (output blocks per group) as launch_float
// says
int blast_matmul_f32(const void* x, const void* U, const void* S,
                     const void* V, void* y, void* part, int T_rows, int G,
                     int b, int p, int q, int r, int rps, int ipg,
                     void* stream) {
  return launch_float<float>(x, U, S, V, y, part, T_rows, G, b, p, q, r, rps,
                             ipg, stream);
}

int blast_matmul_bf16(const void* x, const void* U, const void* S,
                      const void* V, void* y, void* part, int T_rows, int G,
                      int b, int p, int q, int r, int rps, int ipg,
                      void* stream) {
  return launch_float<__nv_bfloat16>(x, U, S, V, y, part, T_rows, G, b, p,
                                     q, r, rps, ipg, stream);
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
