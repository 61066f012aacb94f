// Fused BLAST matmul (paper Alg. 1) for Hopper: float factors, int8 or
// nibble-packed int4 factor codes with per-block scales, and int8 or int4
// factors with per-token int8 activation codes (W8A8, W4A8); each plain and
// grouped, all through one kernel, blast_tile_kernel.
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
// Batched (the MoE experts, beyond the Pallas set: the reference runs its
// experts as a vmapped BLAST over an (E, C, d) buffer in XLA,
// src/repro/models/moe.py:163-170 _expert_ffn): x (G, T, n), factor set g
// on its own x_g — the same kernel with a per-set x stride (and sx stride).
// Float: x and the factors are fp32 or bf16 (one type for all four).
// int8 (as the TPU kernels' _quant_loaders): U/S/V are int8 codes with fp32
// scales su (G, b), ss (G, b, b), sv (G, b); z_j is scaled once by
// sv[g, j], stage 2 uses code(s_ij)·ss[g, i, j], and the block's y
// accumulator is scaled once by su[g, i] before the store (su is constant
// over the output block, so that is exact).  x is fp32 or bf16 and y has
// x's type.
// int4: as int8, but U/S/V rows are r/2 bytes, two codes in [-7, 7] per
// byte (byte k holds logical rank 2k in its low nibble and 2k+1 in its
// high nibble, the quant/qarray.py layout).  The kernels read byte k >> 1
// and sign-extend nibble k & 1 in-register, so they walk the logical rank
// order directly.  (The TPU kernel unpacks each tile into plane order
// [low | high] instead; both are exact, because stages 2–3 reduce over r
// and any rank permutation shared by U, S and V leaves the sum unchanged
// up to fp32 summation order.)
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
// What bounds the kernel is its own overhead, not that bound.
//
// The design (B1, B2, B1 as the backward's dx; B5–B12).  The TPU kernel
// fills its z scratch once per (T tile, r tile), at i == 0, and reuses it
// for every output block; so does this one.  A block of 16 warps owns 16 token rows, factor set g, a range of r
// (a split) and a group of up to 16 output blocks (all b unless the plan
// groups them, or b > 16): per r tile of RT ranks it computes z_j for
// every j, w_i for its i, and adds w_i U_iᵀ into the fp32 accumulator of
// y_i that warp i holds in registers across the whole r range — stage 1
// runs once per (T tile, r tile, group), not once per output block.
// Registers hold up to 96 columns of y_i: a wider p (or one whose tiles
// would not fit shared memory) is cut into column chunks, one block each,
// which repeat stage 1 (none at smollm-135m's shapes).  The x tile and the
// V, S and U r-tiles go through shared memory by cp.async; each factor's
// next tile starts copying as soon as its buffer has been consumed, so the
// copy overlaps the other two stages; no inner loop reads device memory.
// bf16: stages 1 and 3 are mma.sync.m16n8k16 bf16 → fp32, x from shared
// memory by ldmatrix, rows padded to 48 bytes so that an 8-row load hits 8
// bank groups; q and p are zero-padded to 16 and 8 (exact).  Tokens sit on
// the m = 16 side; at T ≤ 8 half the fragment is unused rows, which decode
// does not notice: it is bound by the copies' latency, not by the tensor
// cores.  w enters stage 3 as two bf16 parts, hi = bf16(w) and lo = bf16(w
// − hi), in two mma passes over the same U fragment: w rounded once to
// bf16 moved y past the 2e-2 check at entries near zero.
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
// x rows past T are left unset (every stage keeps token rows apart, and
// those rows of y are not stored); r must be a multiple of 16 (the wrapper
// zero-pads: exact).
// Any n: where the x tile and the V r-tile of all b input blocks fit
// shared memory (n = b·q up to 2,048 at b = 16 for float), the block keeps
// x resident and stages V whole per r tile ("resident"; warp j mod 16
// computes z_j).  Past that, the input axis is staged in panels that the
// r tile's stage 1 walks in turn ("panels", a second instantiation): jc
// whole blocks at a time (a power of two below b, up to 16), each block's
// rows shared by 16/jc warps in 16-row slices, or, where one block alone
// is too wide, kc rows of one block at a time, all 16 warps sharing them.
// A warp keeps its partial z_j in registers across a block's panels;
// warps that share a block add their partials through shared memory in
// warp order (deterministic).  x is then copied again per r tile (from L2).
// Only b bounds the tiles (the z and S tiles grow with b; b ≤ 64 fits).
// Codes (the factor loader is a template parameter: CopyRow for float
// factors, CodeRow8 / CodeRow4 for int8 / packed int4 codes): the factor
// tiles are staged raw, 1 or ½ byte a rank, so a tile row is 16 or 8 bytes
// (bf16 x; 8 or 4 with fp32 x) — one cp.async a row.  A longer rank tile
// (32-byte code rows, as the float rows) would halve the splits at decode
// and double the z and w tiles; RT stays 16, the float kernel's granule,
// so both share split_plan.  The codes become MMA operands in registers
// (exact for |code| ≤ 127): stage 1 builds V's B fragment from 4 code
// bytes, stage 3 U's from 2 adjacent codes (int4: two nibbles become a
// bf16 pair by bit operations and one subtraction); fp32 converts them as
// it reads them.  The scales ride in shared memory and multiply stage
// outputs: sv the fp32 z tile, ss each code of stage 2, su y_i in the
// epilogue.
// What bounds it: per r tile, the copies — each warp's cp.async touches
// 16 (float) or 32 (codes) factor rows and the load/store unit takes them
// row by row — then the three stages' latency chains and barriers; at
// decode, the fixed chain of launch, prologue, one tile, epilogue and the
// split sum.  TMA (one instruction per tile instead of a row per lane), a
// tile-major factor layout, wgmma and warp specialisation are later work.
// Activation codes (ActRow8 / ActRow4: W8A8 / W4A8, B9–B12): the x tile
// holds xq's int8 codes (rows padded by 16 bytes, so that an 8-row
// ldmatrix hits 8 bank groups) and stage 1 runs on s8 tensor cores,
// mma.sync.m16n8k32 s8 × s8 → s32, for either y type: A by ldmatrix (16
// token rows × 32 codes), B from 4 code bytes of one rank in 4 V tile rows
// (int4: nibbles sign-extended to bytes by bit operations).  The
// contraction is zero-padded to 32 (exact).  z stays int32 in registers
// across a block's panels, warps that share a block add their partials in
// int32 (exact, so the result does not depend on the panel layout), and
// z_j = (float)acc · (sx_t · sv_j) once, the TPU kernel's order; the 16
// token scales ride in the scale region.  Stages 2–3, the plan and the
// split sum are those of the output type's code path.  The per-token
// quantize stays a plain PyTorch prologue, as the TPU kernel's runs in XLA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "ptx.cuh"

namespace {

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void put(int8_t* p, float v) { *p = (int8_t)v; }

// The factor value at a logical rank: itself for unpacked types; for packed
// int4 (F = uint8_t, the byte holding the rank) the low nibble (hi = 0) or
// the high nibble (hi = 1), sign-extended.
template <typename F>
__device__ __forceinline__ F code(F v, int) { return v; }
__device__ __forceinline__ int code(uint8_t v, int hi) {
  const int nib = hi ? v >> 4 : v & 0xF;
  return (nib ^ 8) - 8;
}

constexpr int FBT = 16;          // token rows per block: one m16 fragment
constexpr int FNW = 16;          // warps: warp j computes z_j, warp i owns y_i
constexpr int FNT = FNW * 32;    // threads per block
constexpr int FMAXB = FNW;       // output blocks per block: one warp each
constexpr int FRANKS = 16;       // rank granule of the padding and the splits
constexpr int FMAXP8 = 12;       // columns per block ≤ 96 (8-column fragments)
constexpr int SMEM_MAX = 232448; // shared memory one block may opt in to

// Per y type E: RT ranks per r tile and the w tile's row stride, in
// elements (bf16 pads each ldmatrix'd row to 48 bytes, so that 8
// consecutive rows fall into 8 distinct bank groups; fp32 pads the rows a
// warp reads 8 at once).
template <typename E> struct FTile;
template <> struct FTile<__nv_bfloat16> {
  static constexpr int RT = 16, WROW = 24;
};
template <> struct FTile<float> {
  static constexpr int RT = 8, WROW = 12;
};

// Factor loaders: what a factor tile holds and how its rows are copied.
// E: y (and x where X is E); X: an x-tile element; F: a tile element, as
// the factor is stored in device memory (codes are staged raw); logical
// rank k sits in element k >> SH; VROW, UROW, SROW: the V, U and S tiles'
// row strides, in F; a tile row is PARTS cp.asyncs of CP bytes, adjacent
// lanes taking the parts of one row; A8: int8 activation codes.
// Float factors: a tile row is 32 bytes (RT values), copied in two halves,
// so that a warp's copies touch 16 rows (32-byte segments) and not 32.
template <typename E_> struct CopyRow {
  using E = E_;
  using X = E_;
  using F = E_;
  static constexpr bool CODES = false, A8 = false;
  static constexpr int SH = 0, CP = 16, PARTS = 2, SROW = FTile<E>::RT;
  static constexpr int VROW = std::is_same<E, float>::value ? 8 : 24;
  static constexpr int UROW = std::is_same<E, float>::value ? 12 : 24;
};
// int8 codes: a tile row is RT bytes, one copy
template <typename E_> struct CodeRow8 {
  using E = E_;
  using X = E_;
  using F = int8_t;
  static constexpr bool CODES = true, A8 = false;
  static constexpr int SH = 0, CP = FTile<E>::RT, PARTS = 1;
  static constexpr int VROW = CP, UROW = CP, SROW = CP;
};
// nibble-packed int4 codes: a tile row is RT / 2 bytes, one copy
template <typename E_> struct CodeRow4 {
  using E = E_;
  using X = E_;
  using F = uint8_t;
  static constexpr bool CODES = true, A8 = false;
  static constexpr int SH = 1, CP = FTile<E>::RT / 2, PARTS = 1;
  static constexpr int VROW = CP, UROW = CP, SROW = CP;
};
// W8A8 / W4A8: int8 activation codes in the x tile, the factor tiles as
// CodeRow8 / CodeRow4; y of type E
template <typename E_> struct ActRow8 : CodeRow8<E_> {
  using X = int8_t;
  static constexpr bool A8 = true;
};
template <typename E_> struct ActRow4 : CodeRow4<E_> {
  using X = int8_t;
  static constexpr bool A8 = true;
};
// the contraction granule: x columns and V rows are zero-padded to it
template <class L> constexpr int KG = L::A8 ? 32 : 16;

__host__ __device__ constexpr int up16(int v) { return (v + 15) & ~15; }

// Byte offsets of the shared-memory regions (each a multiple of 16 bytes)
// of a block that owns up to nb output blocks and pc columns of each, and
// stages jc input blocks of kc rows at a time (resident: jc = b, kc = q
// rounded up to KG): x tile (FBT, jc·kc + pad of X: block jl at column
// jl·kc), V r-tile (jc·kc rows), U r-tile (nb·pc rows), S r-tile (nb·b
// rows), z (b, FBT, RT) fp32, w (nb, FBT rows; bf16: hi parts, then lo
// parts), with red the warps' partial z (FNW, FBT, RT) fp32 (int32 for
// A8), and for codes the scales sv (b), ss (nb, b), su (nb), and for A8
// sx (FBT).  The epilogue's fp32 y tile (FBT, nb·pc + 8) overlays them.
template <class L> struct FLayout {
  int ldx, xs, vs, us, ss, zs, ws, rd, sc, bytes;
  __host__ __device__ FLayout(int b, int nb, int pc, int jc, int kc,
                              bool red) {
    using E = typename L::E;
    constexpr int e = (int)sizeof(E), f = (int)sizeof(typename L::F);
    constexpr int xe = (int)sizeof(typename L::X);
    constexpr int RT = FTile<E>::RT, WROW = FTile<E>::WROW;
    ldx = jc * kc + 16 / xe;   // +16 bytes: 8 x rows in 8 bank groups
    int off = 0;
    xs = off; off += FBT * ldx * xe;
    vs = off; off += up16(jc * kc * L::VROW * f);
    us = off; off += up16(nb * pc * L::UROW * f);
    ss = off; off += up16(nb * b * L::SROW * f);
    zs = off; off += b * FBT * RT * 4;
    ws = off; off += (e == 2 ? 2 : 1) * nb * FBT * WROW * e;
    rd = off; if (red) off += FNW * FBT * RT * 4;
    sc = off;
    if (L::CODES) off += up16((b + nb * b + nb + (L::A8 ? FBT : 0)) * 4);
    const int ytile = FBT * (nb * pc + 8) * 4;
    bytes = off > ytile ? off : ytile;
  }
};

// B-fragment registers of codes (two bf16 values, the first in the low
// half), exact.  int4: the nibbles at bits 0–3 and 16–19 of `two` become
// bf16 128 + (n ^ 8) by their bits alone, less 136: (n ^ 8) − 8, the code.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t two) {
  const uint32_t biased = (two & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t bias = 0x43084308u;   // bf16 136.0, twice
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
              *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&v);
}
// ranks k, k + 1 (k even) of one tile row (stage 3's U)
__device__ __forceinline__ uint32_t frag_pair(const int8_t* row, int k) {
  const char2 v = *reinterpret_cast<const char2*>(row + k);
  return bf16x2((float)v.x, (float)v.y);
}
__device__ __forceinline__ uint32_t frag_pair(const uint8_t* row, int k) {
  const uint32_t v = row[k >> 1];
  return nibbles_bf16x2(v | (v << 12));
}
// rank c of two tile rows (stage 1's V)
__device__ __forceinline__ uint32_t frag_col(const int8_t* r0,
                                             const int8_t* r1, int c) {
  return bf16x2((float)r0[c], (float)r1[c]);
}
__device__ __forceinline__ uint32_t frag_col(const uint8_t* r0,
                                             const uint8_t* r1, int c) {
  const int sh = (c & 1) * 4;
  return nibbles_bf16x2(((uint32_t)r0[c >> 1] >> sh) |
                        (((uint32_t)r1[c >> 1] >> sh) << 16));
}

// d += a·b, one m16n8k32 s8 fragment product with int32 accumulators
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// An s8 B-fragment register (stage 1's V, W8A8 / W4A8): rank c of 4
// consecutive tile rows, ld bytes apart, one code a byte, the first row in
// the low byte.  int4: the nibbles of rank c, sign-extended to bytes (a
// nibble with bit 3 set gets bits 4–7 set: times 0x1E, no carry out of
// its byte).
__device__ __forceinline__ uint32_t frag_k4(const int8_t* v, int ld, int c) {
  return (uint32_t)(uint8_t)v[c] | (uint32_t)(uint8_t)v[ld + c] << 8 |
         (uint32_t)(uint8_t)v[2 * ld + c] << 16 |
         (uint32_t)(uint8_t)v[3 * ld + c] << 24;
}
__device__ __forceinline__ uint32_t frag_k4(const uint8_t* v, int ld, int c) {
  const int k = c >> 1;
  const uint32_t four = (uint32_t)v[k] | (uint32_t)v[ld + k] << 8 |
                        (uint32_t)v[2 * ld + k] << 16 |
                        (uint32_t)v[3 * ld + k] << 24;
  const uint32_t nib = (four >> ((c & 1) * 4)) & 0x0F0F0F0Fu;
  return nib | (nib & 0x08080808u) * 0x1Eu;
}

// rank k of a tile row as a float (codes: the code)
__device__ __forceinline__ float rank_at(const float* row, int k) {
  return row[k];
}
__device__ __forceinline__ float rank_at(const int8_t* row, int k) {
  return (float)row[k];
}
__device__ __forceinline__ float rank_at(const uint8_t* row, int k) {
  return (float)code(row[k >> 1], k & 1);
}
// ranks k and k + 1 (k even) of a tile row as floats
__device__ __forceinline__ void pair(const float* row, int k, float& a,
                                     float& b) {
  const float2 v = *reinterpret_cast<const float2*>(row + k);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void pair(const __nv_bfloat16* row, int k,
                                     float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + k);
  a = __low2float(v);
  b = __high2float(v);
}
__device__ __forceinline__ void pair(const int8_t* row, int k, float& a,
                                     float& b) {
  const char2 v = *reinterpret_cast<const char2*>(row + k);
  a = (float)v.x;
  b = (float)v.y;
}
__device__ __forceinline__ void pair(const uint8_t* row, int k, float& a,
                                     float& b) {
  const uint8_t v = row[k >> 1];
  a = (float)code(v, 0);
  b = (float)code(v, 1);
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

// A panel of the input axis: blocks [j0, j0 + nj), rows [k0, k0 + kr) of
// each.
struct Panel {
  int j0, nj, k0, kr;
};

// One block: token rows [t0, t0 + 16) of factor set g, the ranks of one
// split ([lo, lo + rps) ∩ [0, r)), the output blocks of one group ([ib, ib
// + ipg) ∩ [0, b), ipg ≤ 16) and the columns of one chunk of each ([c0, c0
// + pc) ∩ [0, p), pc ≤ 96); blockIdx.y = (split · groups + group) · chunks
// + chunk.  Fragment ownership (m16n8 C layout, lane = 4·gr + tq): rows gr
// and gr + 8, columns 2·tq and 2·tq + 1 of each 8-column tile.  With one
// split the block writes its columns of y (E); with several, of its
// split's fp32 partial, and blast_split_sum adds the partials into y.
// PAN: the input axis in panels of jc blocks × kc rows (see the note);
// otherwise resident (jc, kc are ignored).  su, ss, sv: the scales of
// codes (unused for float factors); sx: the token scales of activation
// codes (A8 only).
template <class L, bool PAN, int P8>
__global__ void __launch_bounds__(FNT, 1)
blast_tile_kernel(const typename L::X* __restrict__ x,
                  const float* __restrict__ sx,
                  const typename L::F* __restrict__ U,
                  const typename L::F* __restrict__ S,
                  const typename L::F* __restrict__ V,
                  const float* __restrict__ su, const float* __restrict__ ss,
                  const float* __restrict__ sv, typename L::E* __restrict__ y,
                  float* __restrict__ part, int T_rows, int b, int p, int q,
                  int r, int rps, int ipg, int pc, int jc, int kc,
                  long long xg, long long sxg) {
  using E = typename L::E;
  using X = typename L::X;
  using F = typename L::F;
  constexpr int RT = FTile<E>::RT, WROW = FTile<E>::WROW;
  constexpr int ZT = FBT * RT;   // one z tile, fp32
  constexpr bool BF = std::is_same<E, __nv_bfloat16>::value;
  constexpr bool CODES = L::CODES, A8 = L::A8;
  constexpr int K = KG<L>;       // contraction granule
  const int groups = (b + ipg - 1) / ipg, chunks = (p + pc - 1) / pc;
  const int splits = gridDim.y / (groups * chunks);
  const int t0 = blockIdx.x * FBT, g = blockIdx.z;
  // factor set g's own x (and token scales): a batched launch strides them
  // by xg and sxg; a grouped launch shares one x (both 0)
  x += (size_t)g * xg;
  if constexpr (L::A8) sx += (size_t)g * sxg;
  const int sg = blockIdx.y / chunks, chunk = blockIdx.y - sg * chunks;
  const int split = sg / groups, grp = sg - split * groups;
  const int lo = split * rps, hi = min(r, lo + rps);
  const int ib = grp * ipg, nb = min(b, ib + ipg) - ib;  // output blocks owned
  const int c0 = chunk * pc, pw = min(pc, p - c0);       // their columns
  const int qpad = (q + K - 1) / K * K, p8 = (pw + 7) / 8, pr = 8 * p8;
  const int n = b * q, m = b * p;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = (lane & 3) * 2;
  const int rows = min(FBT, T_rows - t0);
  const int nbl = min(ipg, b);   // output blocks the tiles hold room for
  if constexpr (!PAN) {
    jc = b;
    kc = qpad;
  }
  const int wpb = PAN ? FNW / jc : 1;     // warps that share an input block
  const int nsub = (q + kc - 1) / kc;     // panels a block's rows run over
  const int npan = nsub > 1 ? b * nsub : (b + jc - 1) / jc;
  const FLayout<L> Lay(b, nbl, pc, jc, kc, PAN && wpb > 1);
  // a split launch's blast_split_sum may start now and wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(128) unsigned char tile_smem[];
  X* xs = reinterpret_cast<X*>(tile_smem + Lay.xs);
  F* vt = reinterpret_cast<F*>(tile_smem + Lay.vs);
  F* ut = reinterpret_cast<F*>(tile_smem + Lay.us);
  F* st = reinterpret_cast<F*>(tile_smem + Lay.ss);
  float* zs = reinterpret_cast<float*>(tile_smem + Lay.zs);
  E* ws = reinterpret_cast<E*>(tile_smem + Lay.ws);
  [[maybe_unused]] float* rd = reinterpret_cast<float*>(tile_smem + Lay.rd);
  [[maybe_unused]] float* scv = reinterpret_cast<float*>(tile_smem + Lay.sc);
  [[maybe_unused]] float* scs = scv + b;        // ss rows of the owned i
  [[maybe_unused]] float* scu = scs + nbl * b;  // su of the owned i
  [[maybe_unused]] float* sct = scu + nbl;      // sx of the tile's rows
  [[maybe_unused]] const int WLO = nbl * FBT * WROW;  // bf16: lo parts
  const int rs = r >> L::SH;                 // a factor row, in F
  const F* Ug = U + (size_t)g * b * p * rs;  // (b, p, r)
  const F* Sg = S + (size_t)g * b * b * rs;  // (b, b, r)
  const F* Vg = V + (size_t)g * b * q * rs;  // (b, q, r)

  auto panel = [&](int c) {
    Panel P;
    if (nsub > 1) {   // kc rows of one block
      P.j0 = c / nsub;
      P.nj = 1;
      P.k0 = (c - P.j0 * nsub) * kc;
      P.kr = min(kc, q - P.k0);
    } else {          // jc whole blocks
      P.j0 = c * jc;
      P.nj = min(jc, b - P.j0);
      P.k0 = 0;
      P.kr = q;
    }
    return P;
  };
  // part h of one tile row, asynchronously
  auto copy_part = [&](F* dst, const F* src, int h) {
    cp_async_n<L::CP>(reinterpret_cast<char*>(dst) + L::CP * h,
                      reinterpret_cast<const char*>(src) + L::CP * h);
  };
  // each r tile's copies: one commit group per factor, always committed
  // (empty past the range) so that the group counts stay fixed
  auto copy_v = [&](const Panel& P, int r0) {   // the panel's V rows
    if (r0 < hi)
      for (int idx = tid; idx < L::PARTS * P.nj * P.kr; idx += FNT) {
        const int row = idx / L::PARTS, jl = row / P.kr, k = row - jl * P.kr;
        copy_part(vt + (jl * kc + k) * L::VROW,
                  Vg + ((size_t)(P.j0 + jl) * q + P.k0 + k) * rs +
                      (r0 >> L::SH),
                  idx % L::PARTS);
      }
    cp_commit();
  };
  auto copy_s = [&](int r0) {   // rows s_i· of the owned i
    if (r0 < hi)
      for (int idx = tid; idx < L::PARTS * nb * b; idx += FNT) {
        const int row = idx / L::PARTS;
        copy_part(st + row * L::SROW,
                  Sg + (size_t)(ib * b + row) * rs + (r0 >> L::SH),
                  idx % L::PARTS);
      }
    cp_commit();
  };
  auto copy_u = [&](int r0) {   // the owned columns of the owned U_i
    if (r0 < hi)
      for (int idx = tid; idx < L::PARTS * nb * pw; idx += FNT) {
        const int row = idx / L::PARTS, il = row / pw, pp = row - il * pw;
        copy_part(ut + (il * pc + pp) * L::UROW,
                  Ug + ((size_t)(ib + il) * p + c0 + pp) * rs + (r0 >> L::SH),
                  idx % L::PARTS);
      }
    cp_commit();
  };
  // A panel's zeros: the x columns and V rows past its kr rows of each
  // block, up to the next multiple of K (never copied into).
  X zero;
  put(&zero, 0.f);
  auto zero_panel = [&](const Panel& P) {
    const int kz = (P.kr + K - 1) / K * K - P.kr;
    if (kz == 0) return;
    for (int idx = tid; idx < rows * P.nj * kz; idx += FNT) {
      const int blk = idx / kz;           // (t, jl) of this pad element
      const int t = blk / P.nj, jl = blk - t * P.nj;
      xs[t * Lay.ldx + jl * kc + P.kr + idx - blk * kz] = zero;
    }
    for (int idx = tid; idx < L::PARTS * P.nj * kz; idx += FNT) {
      const int row = idx / L::PARTS, jl = row / kz;
      zero_n<L::CP>(reinterpret_cast<char*>(
                        vt + (jl * kc + P.kr + row - jl * kz) * L::VROW) +
                    L::CP * (idx % L::PARTS));
    }
  };
  // A panel's x columns, in X, one padded block per j: copied
  // asynchronously in chunks of 16, 8 or 4 bytes (the largest that divides
  // a block's q·sizeof(X) bytes and x's alignment), else (xc = 0) loaded
  // element by element by load_x.  Rows past T are left as they are: every
  // stage keeps token rows apart (mma rows, stage 2 per row) and those rows
  // of y are not stored.
  const int seg = q * (int)sizeof(X);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int xc = seg % 16 == 0 && xa % 16 == 0 ? 16
                 : seg % 8 == 0 && xa % 8 == 0 ? 8
                 : seg % 4 == 0 && xa % 4 == 0 ? 4 : 0;
  auto copy_x = [&](const Panel& P) {
    if (!xc) return;
    const int per = P.kr * (int)sizeof(X) / xc;   // chunks per (t, j)
    for (int idx = tid; idx < rows * P.nj * per; idx += FNT) {
      const int tj = idx / per, t = tj / P.nj, jl = tj - t * P.nj;
      const int off = (idx - tj * per) * xc;
      char* dst = reinterpret_cast<char*>(xs + t * Lay.ldx + jl * kc) + off;
      const char* src = reinterpret_cast<const char*>(
                            x + (size_t)(t0 + t) * n + (P.j0 + jl) * q +
                            P.k0) + off;
      if (xc == 16)
        cp_async16(dst, src);
      else if (xc == 8)
        cp_async8(dst, src);
      else
        cp_async4(dst, src);
    }
  };
  auto load_x = [&](const Panel& P) {
    if (xc) return;
    const int w = P.nj * P.kr;
    for (int idx = tid; idx < rows * w; idx += FNT) {
      const int t = idx / w, c = idx - t * w, jl = c / P.kr;
      xs[t * Lay.ldx + jl * kc + c - jl * P.kr] =
          x[(size_t)(t0 + t) * n + (P.j0 + jl) * q + P.k0 + c - jl * P.kr];
    }
  };

  // Zeros first, before the copies fill the load/store pipe: the first
  // panel's pads, and the pad rows of the U tile.
  const Panel P0 = panel(0);
  zero_panel(P0);
  for (int idx = tid; idx < L::PARTS * nb * (pr - pw); idx += FNT) {
    const int row = idx / L::PARTS, il = row / (pr - pw);
    zero_n<L::CP>(reinterpret_cast<char*>(
                      ut + (il * pc + pw + row - il * (pr - pw)) * L::UROW) +
                  L::CP * (idx % L::PARTS));
  }
  copy_x(P0);
  copy_v(P0, lo);   // commits the x copies with V(lo)
  copy_s(lo);
  copy_u(lo);
  if constexpr (CODES) {
    for (int idx = tid; idx < b; idx += FNT) scv[idx] = sv[(size_t)g * b + idx];
    for (int idx = tid; idx < nb * b; idx += FNT)
      scs[idx] = ss[((size_t)g * b + ib) * b + idx];
    for (int idx = tid; idx < nb; idx += FNT)
      scu[idx] = su[(size_t)g * b + ib + idx];
    if constexpr (A8)   // not read past row T
      for (int idx = tid; idx < FBT; idx += FNT)
        sct[idx] = idx < rows ? sx[t0 + idx] : 0.f;
  }
  load_x(P0);
  float acc[P8][4];
#pragma unroll
  for (int nt = 0; nt < P8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
  // a warp's z_j (16 × RT), across a block's panels: int32 for A8
  std::conditional_t<A8, int, float> z[RT / 8][4];

  // Stage 1 over one panel: z_j (16 × RT) += x_j (16 × kr) · V_j (kr × RT)
  // for the panel's blocks j = j0 + jl, warp jl·wpb + w taking its K-row
  // slices w, w + wpb, ... (resident: warp j mod 16, every row).  Once a
  // block's last rows are in, z_j (codes: times sv_j; A8: times sx_t·sv_j)
  // goes to the z tile, directly where one warp owns the block, else
  // through the warps' partials, added in warp order.
  auto stage1 = [&](const Panel& P) {
    const int kp = (P.kr + K - 1) / K * K;
    const bool last = P.k0 + P.kr == q;
    for (int jl = warp / wpb; jl < P.nj; jl += FNW / wpb) {
      const int w = warp - (warp / wpb) * wpb, j = P.j0 + jl;
      if (P.k0 == 0)
#pragma unroll
        for (int nt = 0; nt < RT / 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) z[nt][c] = 0;
      if constexpr (A8) {   // s8 × s8 → s32, K = 32 codes a step
        for (int kk = K * w; kk < kp; kk += K * wpb) {
          uint32_t a[4];
          ldsm_x4(a, xs + (lane & 15) * Lay.ldx + jl * kc + kk +
                         (lane >> 4) * 16);
          const F* v0 = vt + (jl * kc + kk + 2 * tq) * L::VROW;
#pragma unroll
          for (int nt = 0; nt < RT / 8; ++nt) {
            const int c = nt * 8 + gr;
            mma_s8(z[nt], a, frag_k4(v0, L::VROW, c),
                   frag_k4(v0 + 16 * L::VROW, L::VROW, c));
          }
        }
      } else if constexpr (BF) {
        for (int kk = 16 * w; kk < kp; kk += 16 * wpb) {
          uint32_t a[4];
          ldsm_x4(a, xs + (lane & 15) * Lay.ldx + jl * kc + kk +
                         (lane >> 4) * 8);
          if constexpr (CODES) {   // B fragments from 4 codes each
            const F* v0 = vt + (jl * kc + kk + tq) * L::VROW;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int c = nt * 8 + gr;
              mma_bf16(z[nt], a, frag_col(v0, v0 + L::VROW, c),
                       frag_col(v0 + 8 * L::VROW, v0 + 9 * L::VROW, c));
            }
          } else {
            uint32_t v[4];
            ldsm_x4_t(v, vt + (jl * kc + kk + (lane & 15)) * L::VROW +
                             (lane >> 4) * 8);
            mma_bf16(z[0], a, v[0], v[1]);
            mma_bf16(z[1], a, v[2], v[3]);
          }
        }
      } else {
        const E* x0 = xs + gr * Lay.ldx + jl * kc;
        const E* x1 = x0 + 8 * Lay.ldx;
        const F* vj = vt + jl * kc * L::VROW;
        for (int s = 16 * w; s < P.kr; s += 16 * wpb) {
          const int se = min(s + 16, P.kr);
          for (int k = s; k < se; ++k) {
            const float a0 = x0[k], a1 = x1[k];
            float v0, v1;
            pair(vj + k * L::VROW, tq, v0, v1);
            z[0][0] = fmaf(a0, v0, z[0][0]);
            z[0][1] = fmaf(a0, v1, z[0][1]);
            z[0][2] = fmaf(a1, v0, z[0][2]);
            z[0][3] = fmaf(a1, v1, z[0][3]);
          }
        }
      }
      if (!last) continue;
      if constexpr (A8) {   // exact int32: scaled once, or a partial as is
        const float sa = sct[gr] * scv[j], sb = sct[gr + 8] * scv[j];
        int* zi = reinterpret_cast<int*>(rd) + warp * ZT;
#pragma unroll
        for (int nt = 0; nt < RT / 8; ++nt) {
          const int o = gr * RT + nt * 8 + tq;
          if (wpb == 1) {
            float* z0 = zs + j * ZT + o;
            z0[0] = (float)z[nt][0] * sa;
            z0[1] = (float)z[nt][1] * sa;
            z0[8 * RT] = (float)z[nt][2] * sb;
            z0[8 * RT + 1] = (float)z[nt][3] * sb;
          } else {
            zi[o] = z[nt][0];
            zi[o + 1] = z[nt][1];
            zi[o + 8 * RT] = z[nt][2];
            zi[o + 8 * RT + 1] = z[nt][3];
          }
        }
      } else {
        const bool own = wpb == 1;
        float sc = 1.f;
        if constexpr (CODES) sc = own ? scv[j] : 1.f;
        float* zt = own ? zs + j * ZT : rd + warp * ZT;
#pragma unroll
        for (int nt = 0; nt < RT / 8; ++nt) {
          float* z0 = zt + gr * RT + nt * 8 + tq;
          if constexpr (CODES) {
            z0[0] = z[nt][0] * sc;
            z0[1] = z[nt][1] * sc;
            z0[8 * RT] = z[nt][2] * sc;
            z0[8 * RT + 1] = z[nt][3] * sc;
          } else {
            z0[0] = z[nt][0];
            z0[1] = z[nt][1];
            z0[8 * RT] = z[nt][2];
            z0[8 * RT + 1] = z[nt][3];
          }
        }
      }
    }
    if constexpr (PAN) {
      if (wpb > 1 && last) {
        __syncthreads();   // every warp's partial is in
        for (int e = tid; e < P.nj * ZT; e += FNT) {
          const int jl = e / ZT, o = e - jl * ZT;
          if constexpr (A8) {
            const int* rdi = reinterpret_cast<const int*>(rd);
            int s = 0;
            for (int w = 0; w < wpb; ++w) s += rdi[(jl * wpb + w) * ZT + o];
            zs[(P.j0 + jl) * ZT + o] =
                (float)s * (sct[o / RT] * scv[P.j0 + jl]);
          } else {
            float s = 0.f;
            for (int w = 0; w < wpb; ++w) s += rd[(jl * wpb + w) * ZT + o];
            if constexpr (CODES) s *= scv[P.j0 + jl];
            zs[(P.j0 + jl) * ZT + o] = s;
          }
        }
      }
    }
  };

  cp_wait<2>();      // V(lo) landed; S(lo), U(lo) may be in flight
  __syncthreads();
  for (int r0 = lo; r0 < hi; r0 += RT) {
    stage1(P0);
    if constexpr (PAN)
      for (int c = 1; c < npan; ++c) {   // the next panel of this r tile
        const Panel P = panel(c);
        __syncthreads();   // the last panel consumed
        zero_panel(P);
        copy_x(P);
        copy_v(P, r0);
        load_x(P);
        cp_wait<0>();
        __syncthreads();
        stage1(P);
      }
    cp_wait<1>();    // S(r0)
    __syncthreads(); // z ready, V tile free, S tile landed
    if constexpr (PAN) {   // the next r tile's first panel
      if (r0 + RT < hi) {
        zero_panel(P0);
        copy_x(P0);
      }
      copy_v(P0, r0 + RT);
      if (r0 + RT < hi) load_x(P0);
    } else {
      copy_v(P0, r0 + RT);
    }
    // stage 2: w_i[t, rr] = Σ_j s_ij[rr] · z_j[t, rr], fp32, j in order
    // (codes: s_ij = code · ss[g, i, j]).  A thread owns 2 i × 2 t × 2
    // adjacent ranks: per j, 2 S pairs (broadcast over the warp's t lanes)
    // and 2 z pairs for 8 FMAs.  Warps whose token rows all lie past T skip
    // (at decode, half of them).
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
            const int ia = a ? i1 : i0;
            float s0, s1;
            pair(st + (ia * b + j) * L::SROW, rr, s0, s1);
            if constexpr (CODES) {
              const float c = scs[ia * b + j];
              s0 *= c;
              s1 *= c;
            }
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
              store_w(ws + ((i0 + a) * FBT + (c ? tb : ta)) * WROW + rr, WLO,
                      w[a][c][0], w[a][c][1]);
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
        const E* wi = ws + (i * FBT + (lane & 15)) * WROW + (lane >> 4) * 8;
        ldsm_x4(a, wi);
        ldsm_x4(lo4, wi + WLO);
#pragma unroll
        for (int nt = 0; nt < P8; ++nt)
          if (nt < p8) {
            uint32_t u[2];
            if constexpr (CODES) {   // B fragment from 2 code pairs
              const F* urow = ut + (i * pc + nt * 8 + gr) * L::UROW;
              u[0] = frag_pair(urow, tq);
              u[1] = frag_pair(urow, tq + 8);
            } else {
              ldsm_x2(u, ut + (i * pc + nt * 8 + (lane & 7)) * L::UROW +
                             ((lane >> 3) & 1) * 8);
            }
            mma_bf16(acc[nt], a, u[0], u[1]);
            mma_bf16(acc[nt], lo4, u[0], u[1]);
          }
      } else {
        const E* w0 = ws + (i * FBT + gr) * WROW;
        const E* w1 = w0 + 8 * WROW;
#pragma unroll
        for (int nt = 0; nt < P8; ++nt)
          if (nt < p8) {
            const F* u0 = ut + (i * pc + nt * 8 + tq) * L::UROW;
            const F* u1 = u0 + L::UROW;
#pragma unroll
            for (int rr = 0; rr < RT; ++rr) {
              const float ua = rank_at(u0, rr), ub = rank_at(u1, rr);
              acc[nt][0] = fmaf(w0[rr], ua, acc[nt][0]);
              acc[nt][1] = fmaf(w0[rr], ub, acc[nt][1]);
              acc[nt][2] = fmaf(w1[rr], ua, acc[nt][2]);
              acc[nt][3] = fmaf(w1[rr], ub, acc[nt][3]);
            }
          }
      }
    }
    cp_wait<1>();    // V(r0 + RT) (and the first panel's x)
    __syncthreads(); // U and w tiles free, next V tile landed
    copy_u(r0 + RT);
  }
  cp_wait<0>();

  // epilogue: the fragments (codes: times su_i) into an fp32 (16 × nb·pw)
  // tile in shared memory (rows padded by 8 floats), then rows of each
  // owned block out, in 16-byte stores where p allows: y (E), or with a
  // split this split's fp32 partial
  const int wd = nb * pw, ldy = wd + 8;
  float* ys = reinterpret_cast<float*>(tile_smem);
  float sui = 1.f;
  if constexpr (CODES)
    if (warp < nb) sui = scu[warp];
  __syncthreads();   // every warp done with the tiles the y tile overlays
  if (warp < nb) {
#pragma unroll
    for (int nt = 0; nt < P8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // rows gr, gr + 8: columns pp, pp + 1
        const int t = gr + 8 * h, pp = nt * 8 + tq;
        float* yt = ys + t * ldy + warp * pw + pp;
        if (nt < p8 && pp < pw) {
          if constexpr (CODES) {
            yt[0] = acc[nt][2 * h] * sui;
            if (pp + 1 < pw) yt[1] = acc[nt][2 * h + 1] * sui;
          } else {
            yt[0] = acc[nt][2 * h];
            if (pp + 1 < pw) yt[1] = acc[nt][2 * h + 1];
          }
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

// The shared-memory plan of a launch: resident (every input block's x
// columns and V rows at once) at the widest column chunk pc that fits, as
// the float kernel always ran where it could; else panels at the widest
// chunk, of jc whole blocks (a power of two below b, at most 16), or,
// where one block does not fit, of kc rows of one block.  false: not even
// 16 rows fit (the z and S tiles grow with b).
struct TilePlan {
  int pc, jc, kc, smem;
  bool pan;
};

template <class L>
bool plan_tiles(int b, int p, int q, int nb, TilePlan& tp) {
  constexpr int K = KG<L>;
  const int qpad = (q + K - 1) / K * K;
  const int pc0 = 8 * std::min((p + 7) / 8, FMAXP8);
  for (int pc = pc0; pc >= 8; pc -= 8) {
    const int bytes = FLayout<L>(b, nb, pc, b, qpad, false).bytes;
    if (bytes <= SMEM_MAX) {
      tp = {pc, b, qpad, bytes, false};
      return true;
    }
  }
  for (int pc = pc0; pc >= 8; pc -= 8) {
    for (int jc = FNW; jc >= 1; jc /= 2) {
      if (jc >= b) continue;
      const int bytes = FLayout<L>(b, nb, pc, jc, qpad, jc < FNW).bytes;
      if (bytes <= SMEM_MAX) {
        tp = {pc, jc, qpad, bytes, true};
        return true;
      }
    }
    // kc rows of one block: the layout grows by a fixed step per K rows
    const int base = FLayout<L>(b, nb, pc, 1, 0, true).bytes;
    const int step = std::max(FLayout<L>(b, nb, pc, 1, K, true).bytes - base,
                              1);
    for (int kc = std::min(qpad - K, (SMEM_MAX - base) / step * K); kc >= K;
         kc -= K) {
      const int bytes = FLayout<L>(b, nb, pc, 1, kc, true).bytes;
      if (bytes <= SMEM_MAX) {
        tp = {pc, 1, kc, bytes, true};
        return true;
      }
    }
  }
  return false;
}

template <class L, bool PAN, int P8>
int run_tile(const void* x, const void* sx, const void* U, const void* S,
             const void* V, const void* su, const void* ss, const void* sv,
             void* y, float* part, int T_rows, int G, int b, int p, int q,
             int r, int rps, int ipg, long long xg, long long sxg,
             const TilePlan& tp, int splits, cudaStream_t stream) {
  using E = typename L::E;
  using X = typename L::X;
  using F = typename L::F;
  static int opted_in = 48 * 1024;   // per instantiation
  if (tp.smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        blast_tile_kernel<L, PAN, P8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, tp.smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = tp.smem;
  }
  const dim3 grid((T_rows + FBT - 1) / FBT,
                  splits * ((b + ipg - 1) / ipg) * ((p + tp.pc - 1) / tp.pc),
                  G);
  blast_tile_kernel<L, PAN, P8><<<grid, FNT, tp.smem, stream>>>(
      (const X*)x, (const float*)sx, (const F*)U, (const F*)S, (const F*)V, (const float*)su,
      (const float*)ss, (const float*)sv, (E*)y, part, T_rows, b, p, q, r,
      rps, ipg, tp.pc, tp.jc, tp.kc, xg, sxg);
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
                                 (E*)y, total, splits);
}

// x (T, n) of type L::X — or (G, T, n) with xg = T·n, one x per factor set
// (the batched launch) —, y (G, T, m) of type L::E; U/S/V (G, b, ·, r) as
// L stores them (r logical ranks; packed int4 rows are r/2 bytes); su (G,
// b), ss (G, b, b), sv (G, b) fp32 for codes; sx (T, 1) — batched (G, T,
// 1), sxg = T — fp32 for activation codes.  The grid is (⌈T/16⌉, splits of r
// (rps ranks each) × groups of ipg ≤ 16 output blocks × chunks of pc
// columns, G), pc and the panels as plan_tiles chooses.  With rps < r (a
// split launch), part is an fp32 workspace (splits, G, T, m); unused (may
// be null) otherwise.  cudaErrorInvalidValue: a bad argument, or a b so
// large that the z and S tiles alone do not fit.
template <class L>
int launch_tile(const void* x, const void* sx, const void* U, const void* S,
                const void* V, const void* su, const void* ss, const void* sv,
                void* y, void* part, int T_rows, int G, int b, int p, int q,
                int r, int rps, int ipg, long long xg, long long sxg,
                void* stream) {
  if (T_rows <= 0 || G <= 0 || b <= 0 || p <= 0 || q <= 0 || r <= 0 ||
      xg < 0 || sxg < 0 ||
      r % FRANKS != 0 || rps <= 0 || rps % FRANKS != 0 || ipg <= 0 ||
      ipg > FMAXB || (L::CODES && (!su || !ss || !sv)) || (L::A8 && !sx))
    return (int)cudaErrorInvalidValue;
  const int splits = (r + rps - 1) / rps;
  if (splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  TilePlan tp;
  if (!plan_tiles<L>(b, p, q, std::min(ipg, b), tp))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* pf = (float*)part;
  auto run = [&](auto fn) {
    return fn(x, sx, U, S, V, su, ss, sv, y, pf, T_rows, G, b, p, q, r, rps,
              ipg, xg, sxg, tp, splits, st);
  };
  if (tp.pan) return run(run_tile<L, true, FMAXP8>);
  if (tp.pc <= 32) return run(run_tile<L, false, 4>);
  if (tp.pc <= 64) return run(run_tile<L, false, 8>);
  return run(run_tile<L, false, FMAXP8>);
}

}  // namespace

extern "C" {

// the tile kernel's token rows per block, the rank granule of its padding
// and splits, and its output blocks per block, at most
int blast_float_tile_t() { return FBT; }
int blast_float_tile_r() { return FRANKS; }
int blast_float_tile_b() { return FMAXB; }

// Every entry point: part, rps (ranks per split) and ipg (output blocks per
// group) as launch_tile says; xg and sxg the per-factor-set strides of x
// and sx, in elements (0: every set reads one x, the grouped launch; T·n
// and T: each set reads its own (T, n) rows, the batched launch).
#define BLAST_TAIL                                                   \
  void* y, void* part, int T_rows, int G, int b, int p, int q, int r, \
      int rps, int ipg, long long xg, long long sxg, void* stream
#define BLAST_ARGS y, part, T_rows, G, b, p, q, r, rps, ipg, xg, sxg, stream

// float factors: x, U, S, V and y of one type
int blast_matmul_f32(const void* x, const void* U, const void* S,
                     const void* V, BLAST_TAIL) {
  return launch_tile<CopyRow<float>>(x, nullptr, U, S, V, nullptr, nullptr,
                                     nullptr, BLAST_ARGS);
}

int blast_matmul_bf16(const void* x, const void* U, const void* S,
                      const void* V, BLAST_TAIL) {
  return launch_tile<CopyRow<__nv_bfloat16>>(x, nullptr, U, S, V, nullptr,
                                             nullptr, nullptr, BLAST_ARGS);
}

// int8 factor codes, float x; y has x's type
int blast_matmul_q_f32(const void* x, const void* U, const void* S,
                       const void* V, const void* su, const void* ss,
                       const void* sv, BLAST_TAIL) {
  return launch_tile<CodeRow8<float>>(x, nullptr, U, S, V, su, ss, sv,
                                      BLAST_ARGS);
}

int blast_matmul_q_bf16(const void* x, const void* U, const void* S,
                        const void* V, const void* su, const void* ss,
                        const void* sv, BLAST_TAIL) {
  return launch_tile<CodeRow8<__nv_bfloat16>>(x, nullptr, U, S, V, su, ss,
                                              sv, BLAST_ARGS);
}

// int4 factor codes, nibble-packed (uint8, r/2 bytes per row; r counts
// logical ranks), float x; y has x's type
int blast_matmul_q4_f32(const void* x, const void* U, const void* S,
                        const void* V, const void* su, const void* ss,
                        const void* sv, BLAST_TAIL) {
  return launch_tile<CodeRow4<float>>(x, nullptr, U, S, V, su, ss, sv,
                                      BLAST_ARGS);
}

int blast_matmul_q4_bf16(const void* x, const void* U, const void* S,
                         const void* V, const void* su, const void* ss,
                         const void* sv, BLAST_TAIL) {
  return launch_tile<CodeRow4<__nv_bfloat16>>(x, nullptr, U, S, V, su, ss,
                                              sv, BLAST_ARGS);
}

// W8A8: int8 activation codes xq (T, n) with fp32 token scales sx (T, 1)
// against int8 factor codes; the suffix names y's type
int blast_matmul_w8a8_f32(const void* xq, const void* sx, const void* U,
                          const void* S, const void* V, const void* su,
                          const void* ss, const void* sv, BLAST_TAIL) {
  return launch_tile<ActRow8<float>>(xq, sx, U, S, V, su, ss, sv,
                                     BLAST_ARGS);
}

int blast_matmul_w8a8_bf16(const void* xq, const void* sx, const void* U,
                           const void* S, const void* V, const void* su,
                           const void* ss, const void* sv, BLAST_TAIL) {
  return launch_tile<ActRow8<__nv_bfloat16>>(xq, sx, U, S, V, su, ss, sv,
                                             BLAST_ARGS);
}

// W4A8: as W8A8, against nibble-packed int4 factor codes
int blast_matmul_w4a8_f32(const void* xq, const void* sx, const void* U,
                          const void* S, const void* V, const void* su,
                          const void* ss, const void* sv, BLAST_TAIL) {
  return launch_tile<ActRow4<float>>(xq, sx, U, S, V, su, ss, sv,
                                     BLAST_ARGS);
}

int blast_matmul_w4a8_bf16(const void* xq, const void* sx, const void* U,
                           const void* S, const void* V, const void* su,
                           const void* ss, const void* sv, BLAST_TAIL) {
  return launch_tile<ActRow4<__nv_bfloat16>>(xq, sx, U, S, V, su, ss, sv,
                                             BLAST_ARGS);
}

#undef BLAST_TAIL
#undef BLAST_ARGS

}  // extern "C"
