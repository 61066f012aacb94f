// Flash attention for Hopper: the full-sequence kernel and the
// chunked-prefill kernel at per-row offsets.
//
// Replaces:
//   src/repro/kernels/flash_attention.py::flash_attention_pallas (:98)
//     — entry points flash_full_f32 / flash_full_bf16: a static q_offset;
//   src/repro/kernels/flash_attention.py::flash_attention_prefill_pallas
//     (:155) — entry points flash_prefill_f32 / flash_prefill_bf16: a per-row
//     offset read from q_offsets[b];
//   and, beyond the Pallas set, the reference's int8-cache read
//     (src/repro/models/layers.py:416-424: dequantize_rows of the cache it
//     just wrote, then attention, in XLA) — entry points flash_prefill_q8_f32
//     / flash_prefill_q8_bf16: B3 with k and v int8 codes and per-(slot,
//     head) bf16 scales k_scale, v_scale (B, Hkv, S).
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
// type); scores, softmax and the P·V sums are fp32, with scale 1/sqrt(D).
// Any head dim that is a multiple of 8 up to 256.  Over int8 K/V each key
// reads as bf16(float(code) · float(scale)) in the bf16 kernel and
// float(code) · float(scale) in the fp32 one: dequantize_rows to q's type
// (the product is exact in fp32 and rounds once).
//
// What bounds it on the H100.  Prefill (C ≤ 32 queries against S ≤ 512
// slots) and decode are bytes-bound: 4·C·S·D FLOPs per head against
// reading the live prefix of each row's K/V.  The full-sequence kernel is
// bytes-bound at training shapes (B = 8, T = 256, D = 64: 6.3 MB against
// 0.6 GFLOP causal) and operations-bound from T ≈ 1k (T = 2048: 4.8 GFLOP
// causal, 1.9 MB).
//
// Over int8 K/V the tiles cost half the bytes, and the loader does the
// dequantize: a tile's codes (64 keys × D bytes) go to shared memory by
// cp.async, 8 bytes a copy, double-buffered as bf16 tiles are; its 64 + 64
// scales, strided by Hkv in the cache, by plain loads beside them.  Once a
// tile has landed, the block writes bf16(code · scale) into one bf16 K/V
// tile and the MMA loop below runs on it unchanged (one more barrier a
// tile).
//
// bf16: attn_tile_kernel, FlashAttention-2 style on tensor cores.
// - A block is up to 4 warps, each owning 16 query rows.  A row is one
//   (token, query head).  The full-sequence kernel packs one head: a block
//   is (row b, query head, tile of 64 tokens), 4 warps.  The prefill kernel
//   packs the G = Hq / Hkv query heads of one kv head: a block is (row b, kv
//   head, tile of packed rows), packed row r = t·G + g taking query head
//   kvh·G + g of token t, so K/V is read once per kv head instead of G
//   times and decode fills G of a fragment's 16 rows instead of 1.  Each
//   row keeps its own causal limit and window start.  Tiles are issued
//   last-first, so the longest causal rows start first.
// - Q is staged once by cp.async; its A fragments (ldmatrix) stay in
//   registers for D ≤ 128 and are re-read from shared memory per tile above
//   that.  K/V tiles of 64 keys go through two shared-memory stages by
//   cp.async: the next tile's copy is issued before the current tile's
//   MMAs, one __syncthreads a tile.  Rows are padded by 16 bytes so that
//   ldmatrix is free of bank conflicts; a head dim that is not a multiple
//   of 16 is zero-padded to one in shared memory (exact).  Keys past the
//   block's range are zero-filled, never read.  Head dims 64, 128 and 256
//   take instantiations whose head-dim loops are compile-time (with a
//   runtime D each k-step is its own basic block and the MMAs of one step
//   cannot overlap the next step's ldmatrix: 1.7× slower on the H100 at
//   B = 1, T = 2048).
// - S = QKᵀ on mma.sync.m16n8k16 bf16 → fp32 (K's B fragments by
//   ldmatrix); scale (with log2 e folded in, for exp2) and masks applied to
//   the fp32 scores in registers, the mask skipped on tiles that every row
//   sees in full; the online softmax (running max m, sum l, as the TPU
//   kernel keeps them in VMEM scratch) in registers, the row max and sum
//   reduced over the 4 lanes of a quad.  P is rounded to bf16 and reused in
//   registers as the A operand of P·V (the m16n8 C fragment has the
//   m16n8k16 A layout); V's B fragments by ldmatrix.trans; O in fp32
//   registers.  The epilogue divides by l, or writes 0 where l = 0.
// - Dead KV tiles are never loaded (the TPU kernel's `live` predicate):
//   each block walks only the keys its rows can see.
// - Split KV (prefill, where B·Hkv·row tiles leave most SMs idle): the key
//   axis is cut into ranges of whole tiles (the plan,
//   kernels/flash_attention.py::split_plan, reads no device data), one
//   block each, writing its rows' fp32 (acc, m, l) to scratch that the
//   wrapper allocates.  attn_split_combine, a programmatic dependent launch,
//   adds the splits in split order (bitwise equal from run to run); a split
//   with l = 0 contributes nothing, and a row with l = 0 in every split
//   returns 0.
//
// fp32: attn_kernel, on CUDA cores, the path of the 1e-4 checks (TF32
// would not hold them).  One block per (row b, query head, tile of BQ
// queries) — BQ = 16 with 4 warps for prefill chunks, BQ = 64 with 8 warps
// for full sequences; the largest head dim DM is a template parameter that
// sizes each thread's accumulator slice, 128 or 256 (at 256 both kernels
// take the prefill tile).  An online softmax over KV tiles of 32 keys
// staged in shared memory, each warp owning whole query rows for the
// max/sum reductions and each thread a fixed slice of the accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float M_INIT = -1e30f;      // running-max start (TPU kernel's NEG_INF)
constexpr int DMAX = 256;             // largest head dim

// element strides of q, k, v, o (b, h, t/s) and, over int8 K/V, of the
// scales (b, h, s)
struct Strides {
  long long qb, qh, qt, kb, kh, ks, vb, vh, vs, ob, oh, ot;
  long long sb, sh, ss, tb, th, ts;    // k_scale, v_scale
};

// 12 strides, or 18 with the scales'
Strides make_strides(const long long* s, bool scales) {
  Strides st{s[0], s[1], s[2], s[3], s[4], s[5],
             s[6], s[7], s[8], s[9], s[10], s[11], 0, 0, 0, 0, 0, 0};
  if (scales) {
    st.sb = s[12], st.sh = s[13], st.ss = s[14];
    st.tb = s[15], st.th = s[16], st.ts = s[17];
  }
  return st;
}

template <typename KV>
constexpr bool IS_Q8 = std::is_same_v<KV, int8_t>;

// key or value element p[i] as fp32: a float, or its code times scale[si]
// (scale is null for float K/V, and not read)
template <typename KV>
__device__ __forceinline__ float kv_value(const KV* p, long long i,
                                          const bf16* scale, long long si) {
  if constexpr (IS_Q8<KV>)
    return (float)p[i] * __bfloat162float(scale[si]);
  else
    return p[i];
}

// ---------------------------------------------------------------- fp32 --

constexpr int BKV = 32;       // keys per tile (one per lane in the softmax)
// (query rows, threads) per block
constexpr int PREFILL_BQ = 16, PREFILL_NT = 128;
constexpr int FULL_BQ = 64, FULL_NT = 256;
constexpr int WIDE_D = 128;   // head dims above it take the DM = 256 tiles

// PER_ROW: the query offset is offs[b] (prefill) or the static q_offset.
// DM: the largest head dim D this instantiation takes.  KV: float, or int8
// codes with their scales ksc, vsc.
template <int BQ, int NT, bool PER_ROW, int DM, typename KV>
__global__ void __launch_bounds__(NT)
attn_kernel(const float* __restrict__ q, const KV* __restrict__ k,
            const KV* __restrict__ v, const bf16* __restrict__ ksc,
            const bf16* __restrict__ vsc, const int* __restrict__ offs,
            int q_offset, float* __restrict__ o, int Hq, int Hkv, int C,
            int D, Strides st, int causal, int window, int kv_len,
            float scale) {
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

  const float* qp = q + b * st.qb + h * st.qh;
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int t = idx / D, d = idx - t * D;
    qs[idx] = t < rows ? qp[(t0 + t) * st.qt + d] * scale : 0.f;
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
  const KV* kp = k + b * st.kb + kvh * st.kh;
  const KV* vp = v + b * st.vb + kvh * st.vh;
  const bf16* kscp = IS_Q8<KV> ? ksc + b * st.sb + kvh * st.sh : nullptr;
  const bf16* vscp = IS_Q8<KV> ? vsc + b * st.tb + kvh * st.th : nullptr;

  for (int j0 = (k_begin / BKV) * BKV; j0 < k_end; j0 += BKV) {
    __syncthreads();  // queries ready; the previous tile fully consumed
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int j = idx / D, d = idx - j * D, key = j0 + j;
      const bool in = key < k_end;
      ks[j * (D + 1) + d] =
          in ? kv_value(kp, key * st.ks + d, kscp, key * st.ss) : 0.f;
      vs[j * D + d] =
          in ? kv_value(vp, key * st.vs + d, vscp, key * st.ts) : 0.f;
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
  float* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = tid + e * NT;
    if (idx < BQ * D) {
      const int t = idx / D, d = idx - t * D;
      if (t < rows) {
        const float l = lrow[t];
        op[(t0 + t) * st.ot + d] = l > 0.f ? acc[e] / l : 0.f;
      }
    }
  }
}

template <int BQ, int NT, bool PER_ROW, int DM, typename KV>
int launch_dm(const void* q, const void* k, const void* v, const void* ksc,
              const void* vsc, const void* offs, int q_offset, void* o, int B,
              int Hq, int Hkv, int C, int D, const long long* strides,
              int causal, int window, int kv_len, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > DM ||
      D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)BQ * D + (size_t)BKV * (D + 1) +
                                       (size_t)BKV * D + BQ * BKV + 3 * BQ);
  auto kernel = attn_kernel<BQ, NT, PER_ROW, DM, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * Hq, (C + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const KV*)k, (const KV*)v, (const bf16*)ksc,
      (const bf16*)vsc, (const int*)offs, q_offset, (float*)o, Hq, Hkv, C, D,
      make_strides(strides, IS_Q8<KV>), causal, window, kv_len,
      1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// D ≤ 128: the tiles every smollm-135m launch takes; 128 < D ≤ 256: the
// same kernel with a 256-wide accumulator slice on the prefill tile (16
// query rows, 4 warps) for both (full-sequence tiles of 32 rows × 8 warps
// and 16 rows × 8 warps spilled 60 and 4 bytes)
template <int BQ, int NT, bool PER_ROW, typename KV = float>
int launch_f32(const void* q, const void* k, const void* v, const void* offs,
               int q_offset, void* o, int B, int Hq, int Hkv, int C, int D,
               const long long* strides, int causal, int window, int kv_len,
               void* stream, const void* ksc = nullptr,
               const void* vsc = nullptr) {
  if (D <= WIDE_D)
    return launch_dm<BQ, NT, PER_ROW, WIDE_D, KV>(
        q, k, v, ksc, vsc, offs, q_offset, o, B, Hq, Hkv, C, D, strides,
        causal, window, kv_len, stream);
  return launch_dm<PREFILL_BQ, PREFILL_NT, PER_ROW, DMAX, KV>(
      q, k, v, ksc, vsc, offs, q_offset, o, B, Hq, Hkv, C, D, strides, causal,
      window, kv_len, stream);
}

// ---------------------------------------------------------------- bf16 --

constexpr int KT = 64;          // keys per tile
constexpr int MAX_WARPS = 4;    // a block: up to 4 warps of 16 rows
constexpr float LOG2E = 1.4426950408889634f;

// One block: packed rows r0 .. r0 + 16·warps − 1 of (row b, head group)
// against the keys of split blockIdx.z (all keys when part is null).  P
// query heads are packed (1: full sequence; G: prefill): packed row r is
// token r / P of query head hb + r % P.  DM: the largest padded head dim.
// part: split scratch — acc (splits, B, C, Hq, D), then (m, l) pairs
// (splits, B, C, Hq, 2) — or null, and then o is written.  EXACT: D = DM,
// so the head-dim loops, row strides and copies are compile-time.  KV: bf16,
// or int8 codes with their scales ksc, vsc, dequantized into one bf16 K/V
// tile per key tile.
template <int DM, bool EXACT, typename KV>
__global__ void __launch_bounds__(32 * MAX_WARPS)
attn_tile_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                 const KV* __restrict__ v, const bf16* __restrict__ ksc,
                 const bf16* __restrict__ vsc, const int* __restrict__ offs,
                 int q_offset, bf16* __restrict__ o, float* __restrict__ part,
                 int Hq, int Hkv, int P, int C, int D, Strides st, int causal,
                 int window, int kv_len, int kps, float sl2) {
  constexpr bool Q8 = IS_Q8<KV>;
  constexpr int KV_STAGES = Q8 ? 1 : 2;     // bf16 K/V tiles in shared memory
  // a split launch's attn_split_combine may start now and wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int NK = KT / 8;                 // key n-tiles of S
  constexpr int ND = DM / 8;                 // head-dim n-tiles of O
  constexpr bool QREG = DM <= 128;           // Q's A fragments in registers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, BR = nthr / 2;   // 16 rows a warp
  const int HG = Hq / P, B = gridDim.x / HG;
  const int b = blockIdx.x / HG, hb = (blockIdx.x - b * HG) * P;
  const int kvh = hb / (Hq / Hkv);
  const int R = C * P;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BR;   // last tile first
  const int rows = min(BR, R - r0);
  const int off = offs ? offs[b] : q_offset;
  if (EXACT) D = DM;
  const int DP = (D + 15) & ~15, LD = DP + 8, CPR = D >> 3;
  const bool split = part != nullptr;
  const int s_lo = split ? blockIdx.z * kps : 0;
  const int s_hi = split ? min(kv_len, s_lo + kps) : kv_len;

  // this thread's two rows (fragment rows lane/4 and lane/4 + 8): token,
  // query head and the key range [lo, hi) the row sees in this split
  int rt[2], rh[2], lo[2], hi[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + (lane >> 2) + 8 * i;
    live[i] = r < R;
    rt[i] = r / P;
    rh[i] = hb + r - rt[i] * P;
    const int pos = off + rt[i];
    hi[i] = live[i] ? (causal ? min(s_hi, pos + 1) : s_hi) : 0;
    lo[i] = max(s_lo, window > 0 ? pos - window + 1 : 0);
  }
  // keys some row of the block sees, and keys every row sees
  const int t_lo = r0 / P, t_hi = (r0 + rows - 1) / P;
  const int k_end = causal ? min(s_hi, off + t_hi + 1) : s_hi;
  const int k_begin = max(s_lo, window > 0 ? off + t_lo - window + 1 : 0);
  const int all_hi = causal ? min(s_hi, off + t_lo + 1) : s_hi;
  const int all_lo = max(s_lo, window > 0 ? off + t_hi - window + 1 : 0);

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};

  if (k_begin < k_end) {   // block-uniform: a dead block loads nothing
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* qs = reinterpret_cast<bf16*>(smem);   // (BR, LD)
    bf16* kvs = qs + BR * LD;   // KV_STAGES × (K, V) (KT, LD)
    // int8 K/V: 2 stages × (K, V) of codes (KT, D), then of scales (KT,)
    int8_t* raw = reinterpret_cast<int8_t*>(kvs + KV_STAGES * 2 * KT * LD);
    bf16* rsc = reinterpret_cast<bf16*>(raw + 4 * KT * D);
    if (DP != D)   // the zero pad of D to 16, never written by a copy
      for (int i = tid; i < BR + KV_STAGES * 2 * KT; i += nthr)
        zero_n<16>(qs + i * LD + D);
    const bf16* qb = q + b * st.qb;
    for (int c = tid; c < BR * CPR; c += nthr) {
      const int r = c / CPR, ch = c - r * CPR, gr = r0 + r;
      bf16* dst = qs + r * LD + ch * 8;
      if (gr < R) {
        const int t = gr / P;
        cp_async16(dst, qb + (hb + gr - t * P) * st.qh + t * st.qt + ch * 8);
      } else {
        zero_n<16>(dst);
      }
    }
    const KV* kp = k + b * st.kb + kvh * st.kh;
    const KV* vp = v + b * st.vb + kvh * st.vh;
    auto load = [&](int j0, int stage) {
      if constexpr (Q8) {
        // codes: 8 bytes (8 keys' elements) a copy
        int8_t* kr = raw + stage * 2 * KT * D;
        int8_t* vr = kr + KT * D;
        for (int c = tid; c < KT * CPR; c += nthr) {
          const int j = c / CPR, ch = c - j * CPR, at = j * D + ch * 8;
          if (j0 + j < k_end) {
            cp_async8(kr + at, kp + (j0 + j) * st.ks + ch * 8);
            cp_async8(vr + at, vp + (j0 + j) * st.vs + ch * 8);
          } else {   // past every row's range: zero codes and scales
            zero_n<8>(kr + at);
            zero_n<8>(vr + at);
          }
        }
        // scales, Hkv apart in the cache: plain loads
        bf16* sc = rsc + stage * 2 * KT;
        for (int i = tid; i < 2 * KT; i += nthr) {
          const int j = i & (KT - 1), key = j0 + j;
          const bool isv = i >= KT;
          sc[i] = key < k_end
                      ? (isv ? vsc[b * st.tb + kvh * st.th + key * st.ts]
                             : ksc[b * st.sb + kvh * st.sh + key * st.ss])
                      : __float2bfloat16(0.f);
        }
      } else {
        bf16* ks = kvs + stage * 2 * KT * LD;
        bf16* vs = ks + KT * LD;
        for (int c = tid; c < KT * CPR; c += nthr) {
          const int j = c / CPR, ch = c - j * CPR, at = j * LD + ch * 8;
          if (j0 + j < k_end) {
            cp_async16(ks + at, kp + (j0 + j) * st.ks + ch * 8);
            cp_async16(vs + at, vp + (j0 + j) * st.vs + ch * 8);
          } else {   // past every row's range: zeros (V must stay finite)
            zero_n<16>(ks + at);
            zero_n<16>(vs + at);
          }
        }
      }
      cp_commit();
    };
    // int8 K/V: a landed stage of codes → the bf16 K/V tile, each element
    // bf16(code · its key's scale), 8 elements a thread at a time
    auto dequantize = [&](int stage) {
      const int8_t* kr = raw + stage * 2 * KT * D;
      const bf16* sc = rsc + stage * 2 * KT;
      for (int c = tid; c < 2 * KT * CPR; c += nthr) {
        const int row = c / CPR, ch = c - row * CPR;   // row: K 0-63, V 64-
        const uint2 codes =
            *reinterpret_cast<const uint2*>(kr + row * D + ch * 8);
        const float s = __bfloat162float(sc[row]);
        // element e of the 8: byte e % 4 of word e / 4, sign-extended
        auto x = [&](int e) {
          const uint32_t word = e < 4 ? codes.x : codes.y;
          return (float)(int8_t)(word >> (8 * (e & 3))) * s;
        };
        *reinterpret_cast<uint4*>(kvs + row * LD + ch * 8) =
            make_uint4(bf16x2(x(0), x(1)), bf16x2(x(2), x(3)),
                       bf16x2(x(4), x(5)), bf16x2(x(6), x(7)));
      }
    };
    const int j_first = (k_begin / KT) * KT;
    const int ntiles = (k_end - j_first + KT - 1) / KT;
    load(j_first, 0);   // one group with Q's copies
    // ldmatrix row addresses: A fragments of Q and B fragments of V
    // (.trans) take matrices (rows 0-7, 8-15) × (cols 0-7, 8-15) in column
    // order; K's B fragments take them in row order
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
    const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
    const bf16* qw = qs + (warp * 16 + arow) * LD + acol;
    uint32_t qf[QREG ? DM / 16 : 1][4];

    for (int it = 0; it < ntiles; ++it) {
      const int j0 = j_first + it * KT;
      cp_wait<0>();
      __syncthreads();   // tile it landed; every warp is done with it - 1
      if (it + 1 < ntiles) load(j0 + KT, (it + 1) & 1);
      if constexpr (Q8) {
        dequantize(it & 1);
        __syncthreads();   // the bf16 tile is whole
      }
      if constexpr (QREG) {
        if (it == 0) {
#pragma unroll
          for (int kk = 0; kk < DM / 16; ++kk)
            if (kk * 16 < DP) ldsm_x4(qf[kk], qw + kk * 16);
        }
      }
      const bf16* ks = kvs + (Q8 ? 0 : it & 1) * 2 * KT * LD;
      const bf16* vs = ks + KT * LD;

      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        if (kk * 16 < DP) {
          uint32_t a[4];
          if constexpr (QREG) {
            a[0] = qf[kk][0], a[1] = qf[kk][1], a[2] = qf[kk][2],
            a[3] = qf[kk][3];
          } else {
            ldsm_x4(a, qw + kk * 16);
          }
#pragma unroll
          for (int np = 0; np < NK / 2; ++np) {
            uint32_t bk[4];
            ldsm_x4(bk, ks + (np * 16 + krow) * LD + kk * 16 + kcol);
            mma_bf16(s[2 * np], a, bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
          }
        }
      }
      if (j0 < all_lo || j0 + KT > all_hi) {   // a row misses keys: mask
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + n * 8 + 2 * (lane & 3) + (e & 1);
            if (key < lo[e >> 1] || key >= hi[e >> 1]) s[n][e] = -INFINITY;
          }
      }
      // online softmax in log2 units: m is the running max of s·sl2
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NK; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[i], mx * sl2);
        const float alpha = exp2f(m[i] - mn);
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = exp2f(fmaf(s[n][e], sl2, -mn));  // masked: 0
            s[n][e] = p;
            sum += p;
          }
        l[i] = l[i] * alpha + sum;   // this lane's part; quad sum at the end
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          oacc[n][2 * i] *= alpha;
          oacc[n][2 * i + 1] *= alpha;
        }
      }
      // O += P·V, P rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        const uint32_t a[4] = {bf16x2(s[2 * kk][0], s[2 * kk][1]),
                               bf16x2(s[2 * kk][2], s[2 * kk][3]),
                               bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DM / 16; ++dp) {
          if (dp * 16 < DP) {
            uint32_t bv[4];
            ldsm_x4_t(bv, vs + (kk * 16 + arow) * LD + dp * 16 + acol);
            mma_bf16(oacc[2 * dp], a, bv[0], bv[1]);
            mma_bf16(oacc[2 * dp + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
  }

  // epilogue: this thread's columns 2·(lane % 4) + {0, 1} of each n-tile
  const int B_C_Hq = B * C * Hq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (!live[i]) continue;
    const int d0 = 2 * (lane & 3);
    if (split) {
      const long long row = (long long)blockIdx.z * B_C_Hq +
                            ((long long)b * C + rt[i]) * Hq + rh[i];
      float* po = part + row * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        if (n * 8 < D)
          *reinterpret_cast<float2*>(po + n * 8 + d0) =
              make_float2(oacc[n][2 * i], oacc[n][2 * i + 1]);
      if ((lane & 3) == 0)
        reinterpret_cast<float2*>(part + (long long)gridDim.z * B_C_Hq * D)
            [row] = make_float2(m[i], l[i]);
    } else {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;   // no key: 0
      bf16* po = o + b * st.ob + rh[i] * st.oh + rt[i] * st.ot;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        if (n * 8 < D)
          *reinterpret_cast<uint32_t*>(po + n * 8 + d0) =
              bf16x2(oacc[n][2 * i] * inv, oacc[n][2 * i + 1] * inv);
    }
  }
}

// o = Σ_s w_s·acc_s / Σ_s w_s·l_s with w_s = 2^(m_s − max m), over the
// splits with l_s > 0 in split order (the same sum every run); 0 where no
// split saw a key.  Four head-dim columns of one row a thread.
__global__ void __launch_bounds__(256)
attn_split_combine(const float* __restrict__ part, bf16* __restrict__ o,
                   int B, int C, int Hq, int D, int splits, long long ob,
                   long long oh, long long ot) {
  // launched early (programmatic dependent launch): wait until the tile
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long rows = (long long)B * C * Hq;
  const float2* ml =
      reinterpret_cast<const float2*>(part + (long long)splits * rows * D);
  const int D4 = D >> 2;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < rows * D4; idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / D4;
    const int d = (int)(idx - row * D4) * 4;
    float mx = M_INIT;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[s * rows + row].x);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float2 e = ml[s * rows + row];
      if (e.y > 0.f) {
        const float w = exp2f(e.x - mx);
        const float4 a =
            *reinterpret_cast<const float4*>(part + (s * rows + row) * D + d);
        L += e.y * w;
        acc.x += w * a.x, acc.y += w * a.y, acc.z += w * a.z, acc.w += w * a.w;
      }
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    const int h = (int)(row % Hq);
    const long long bt = row / Hq;
    const int t = (int)(bt % C), b = (int)(bt / C);
    *reinterpret_cast<uint2*>(o + b * ob + h * oh + t * ot + d) =
        make_uint2(bf16x2(acc.x * inv, acc.y * inv),
                   bf16x2(acc.z * inv, acc.w * inv));
  }
}

int launch_combine(const float* part, bf16* o, int B, int C, int Hq, int D,
                   int splits, long long ob, long long oh, long long ot,
                   cudaStream_t stream) {
  const long long total = (long long)B * C * Hq * (D / 4);
  // programmatic dependent launch: the combine's launch overlaps the tile
  // kernel, and griddepcontrol.wait holds its reads until that is done
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min<long long>((total + 255) / 256, 1024));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, attn_split_combine, part, o, B, C, Hq,
                                 D, splits, ob, oh, ot);
}

template <int DM, bool EXACT, typename KV>
int launch_tile_dm(const void* q, const void* k, const void* v,
                   const void* ksc, const void* vsc, const void* offs,
                   int q_offset, void* o, float* part, int B, int Hq, int Hkv,
                   int P, int C, int D, const Strides& st, int causal,
                   int window, int kv_len, int warps, int splits, int kps,
                   cudaStream_t stream) {
  const int LD = ((D + 15) & ~15) + 8;
  // Q and the bf16 K/V tiles; over int8 K/V one bf16 stage, then two of
  // codes and scales
  const size_t smem =
      IS_Q8<KV> ? sizeof(bf16) * (size_t)LD * (16 * warps + 2 * KT) +
                      4 * (size_t)KT * D + 4 * KT * sizeof(bf16)
                : sizeof(bf16) * (size_t)LD * (16 * warps + 4 * KT);
  auto kernel = attn_tile_kernel<DM, EXACT, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int br = 16 * warps;
  const dim3 grid(B * (Hq / P), (C * P + br - 1) / br, splits);
  kernel<<<grid, 32 * warps, smem, stream>>>(
      (const bf16*)q, (const KV*)k, (const KV*)v, (const bf16*)ksc,
      (const bf16*)vsc, (const int*)offs, q_offset, (bf16*)o,
      splits > 1 ? part : nullptr, Hq, Hkv, P, C, D, st, causal, window,
      kv_len, kps, LOG2E / sqrtf((float)D));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return launch_combine(part, (bf16*)o, B, C, Hq, D, splits, st.ob, st.oh,
                        st.ot, stream);
}

// The bf16 kernel at P packed heads, `warps` warps a block and `splits`
// key ranges of kps keys (a multiple of KT covering kv_len; part holds
// splits·B·C·Hq·(D + 2) floats when splits > 1); K/V of type KV (int8:
// with the scales ksc, vsc and 18 strides).
template <typename KV = bf16>
int launch_tile(const void* q, const void* k, const void* v, const void* offs,
                int q_offset, void* o, float* part, int B, int Hq, int Hkv,
                int P, int C, int D, const long long* strides, int causal,
                int window, int kv_len, int warps, int splits, int kps,
                void* stream, const void* ksc = nullptr,
                const void* vsc = nullptr) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > DMAX ||
      D % 8 != 0 || P <= 0 || Hq % P != 0 || (Hq / Hkv) % P != 0 ||
      warps < 1 || warps > MAX_WARPS || splits < 1 ||
      (splits > 1 && (part == nullptr || kps <= 0 || kps % KT != 0 ||
                      (long long)kps * splits < kv_len)))
    return (int)cudaErrorInvalidValue;
  const Strides st = make_strides(strides, IS_Q8<KV>);
  auto s = (cudaStream_t)stream;
#define ATTN_TILE(DM, EXACT)                                               \
  return launch_tile_dm<DM, EXACT, KV>(q, k, v, ksc, vsc, offs, q_offset, \
                                       o, part, B, Hq, Hkv, P, C, D, st,   \
                                       causal, window, kv_len, warps,      \
                                       splits, kps, s)
  switch (D) {
    case 64: ATTN_TILE(64, true);
    case 128: ATTN_TILE(128, true);
    case 256: ATTN_TILE(256, true);
  }
  if (D <= 64) ATTN_TILE(64, false);
  if (D <= 128) ATTN_TILE(128, false);
  ATTN_TILE(256, false);
#undef ATTN_TILE
}

}  // namespace

extern "C" {

int flash_prefill_f32(const void* q, const void* k, const void* v,
                      const void* offs, void* o, int B, int Hq, int Hkv, int C,
                      int D, const long long* strides, int causal, int window,
                      int kv_len, void* stream) {
  return launch_f32<PREFILL_BQ, PREFILL_NT, true>(
      q, k, v, offs, 0, o, B, Hq, Hkv, C, D, strides, causal, window, kv_len,
      stream);
}

// GQA-packed rows (P = Hq / Hkv) on the plan's warps and key splits
int flash_prefill_bf16(const void* q, const void* k, const void* v,
                       const void* offs, void* o, void* part, int B, int Hq,
                       int Hkv, int C, int D, const long long* strides,
                       int causal, int window, int kv_len, int warps,
                       int splits, int kps, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  return launch_tile(q, k, v, offs, 0, o, (float*)part, B, Hq, Hkv, Hq / Hkv,
                     C, D, strides, causal, window, kv_len, warps, splits, kps,
                     stream);
}

// the same over int8 K/V with per-(slot, head) bf16 scales; 18 strides
int flash_prefill_q8_f32(const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         const void* offs, void* o, int B, int Hq, int Hkv,
                         int C, int D, const long long* strides, int causal,
                         int window, int kv_len, void* stream) {
  return launch_f32<PREFILL_BQ, PREFILL_NT, true, int8_t>(
      q, k, v, offs, 0, o, B, Hq, Hkv, C, D, strides, causal, window, kv_len,
      stream, k_scale, v_scale);
}

int flash_prefill_q8_bf16(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* offs, void* o, void* part, int B,
                          int Hq, int Hkv, int C, int D,
                          const long long* strides, int causal, int window,
                          int kv_len, int warps, int splits, int kps,
                          void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  return launch_tile<int8_t>(q, k, v, offs, 0, o, (float*)part, B, Hq, Hkv,
                             Hq / Hkv, C, D, strides, causal, window, kv_len,
                             warps, splits, kps, stream, k_scale, v_scale);
}

int flash_full_f32(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int T, int D,
                   const long long* strides, int causal, int window,
                   int q_offset, int kv_len, void* stream) {
  return launch_f32<FULL_BQ, FULL_NT, false>(
      q, k, v, nullptr, q_offset, o, B, Hq, Hkv, T, D, strides, causal,
      window, kv_len, stream);
}

// one query head a block, 64 tokens from 4 warps, no split
int flash_full_bf16(const void* q, const void* k, const void* v, void* o,
                    int B, int Hq, int Hkv, int T, int D,
                    const long long* strides, int causal, int window,
                    int q_offset, int kv_len, void* stream) {
  return launch_tile(q, k, v, nullptr, q_offset, o, nullptr, B, Hq, Hkv, 1, T,
                     D, strides, causal, window, kv_len, MAX_WARPS, 1, 0,
                     stream);
}

// the split combine alone, on partials laid out as the tile kernel writes
// them: a check of the combine against its plain version
int flash_combine_bf16(const void* part, void* o, int B, int C, int Hq, int D,
                       int splits, const long long* ostrides, void* stream) {
  if (B <= 0 || C <= 0 || Hq <= 0 || D <= 0 || D % 8 != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int rc = launch_combine((const float*)part, (bf16*)o, B, C, Hq, D,
                                splits, ostrides[0], ostrides[1], ostrides[2],
                                (cudaStream_t)stream);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // extern "C"
