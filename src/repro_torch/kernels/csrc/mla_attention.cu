// MLA latent attention for Hopper: DeepSeek-V3's decode and chunked-prefill
// attention over the latent cache, with the up-projections absorbed.
//
// Replaces no Pallas kernel: the reference computes it in XLA, between
// q_lat and o_lat of src/repro/models/layers.py::mla_prefill (:686-702),
// and its Pallas attention kernels (src/repro/kernels/flash_attention.py)
// take one head dim of at most 256 for q, k and v, where these scores span
// 512 + 64 dims and the values 512.
//
// Function: q (B, C, H, 576) = [q_lat (512) ‖ q_rope (64)], one shared key
// per cache slot, [latent (B, S, 512) ‖ k_rope (B, S, 64)], whose first 512
// columns are also the value (MQA: H query heads on one kv head) →
// o (B, C, H, 512) fp32.  Query (b, t) sits at position offs[b] + t and
// sees slot j < kv_len iff 0 <= kpos[b, j] <= offs[b] + t (kpos is the
// cache's pos, -1 empty: a dead column past its row's last key sees the
// keys the reference's does); s = q · k · scale with scale = 1/sqrt(nope +
// rope) = 1/sqrt(192), passed in; softmax over the slots in fp32; a row
// that sees no key gives 0 (the reference masks at -1e30 and gives such a
// row the mean of its latent slots: 0 for an idle row, which the engine
// resets; ROADMAP C3).  Every tensor is read through its strides (last
// axis contiguous).
//
// What bounds it on the H100.  Decode and chunked prefill are bytes-bound:
// a row's live latent slots (1152 bytes each in bf16) are read once for
// all 128 heads, against 2·H·C·(576 + 512) FLOPs a slot — 242 FLOP a byte
// at C = 1, under the card's ~295; at C = 32 the tensor cores bound it.
//
// bf16: mla_tile_kernel, on tensor cores (mma.sync m16n8k16 bf16 → fp32).
// - A block is one row b and 64 packed rows, packed row r = t·H + h (token
//   t, head h): the heads of a token share every key, as B3 packs the G
//   query heads of a kv head.  8 warps: warp w owns the 16 rows of group
//   w % 4 and output columns [256·(w / 4), +256) of them, so its fp32
//   accumulator is 16 × 256 (128 registers a thread); the two warps of a
//   row group both compute the group's scores (the QKᵀ products are done
//   twice, which keeps P in registers and needs no exchange).
// - Q is staged once by cp.async (64 × 576 bf16); its A fragments are
//   re-read by ldmatrix per key tile (576 columns do not fit registers).
//   Key tiles of 32 slots, [latent ‖ k_rope] side by side in one 576-wide
//   shared-memory row, go through two stages by cp.async, the next tile's
//   copy issued before the current tile's products; V is the tile's first
//   512 columns (ldmatrix.trans), so each key is loaded once.  Rows are
//   padded by 16 bytes (1168 bytes: ldmatrix free of bank conflicts).
//   Slots past kv_len are zero-filled and masked.  ~146 KB of shared memory.
// - Scores are masked by each slot's position, staged as a tile of 32
//   ints beside the keys; the online softmax (running max and sum in
//   registers, log2 units) and P rounded to bf16 as the A operand of P·V
//   follow attn_tile_kernel (flash_attention.cu).  The epilogue divides by
//   l (or writes 0 where l = 0) and stores fp32.
// - No key split: at decode a call is B·⌈128/64⌉ = 16 blocks for B = 8
//   (ROADMAP queue B).
// - q is rounded to bf16 for the tensor cores (the reference keeps q_lat
//   in fp32); the products and sums are fp32.
//
// fp32: mla_f32_kernel, on CUDA cores (the 1e-4 checks: TF32 would not hold
// them).  A block is one row b and 16 packed rows; key tiles of 32 slots in
// shared memory (a lane a key in the softmax), each thread a fixed slice of
// 32 accumulator entries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int DL = 512;               // latent (= value) dims
constexpr int DR = 64;                // shared RoPE key dims
constexpr int DQ = DL + DR;           // score dims
constexpr float M_INIT = -1e30f;      // running-max start
constexpr float LOG2E = 1.4426950408889634f;

// element strides: q (b, t, h), latent (b, s), k_rope (b, s), kpos (b),
// o (b, t, h)
struct MlaStrides {
  long long qb, qt, qh, lb, ls, rb, rs, pb, ob, ot, oh;
};

MlaStrides make_strides(const long long* s) {
  return {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10]};
}

// ---------------------------------------------------------------- bf16 --

constexpr int KT = 32;                // keys per tile
constexpr int ROWS = 64;              // packed rows per block
constexpr int NWARP = 8;              // 4 row groups × 2 halves of the value
constexpr int NT = 32 * NWARP;
constexpr int DH = DL / 2;            // output columns a warp
constexpr int LDS = DQ + 8;           // shared-memory row (bf16)
constexpr int CH = DQ / 8;            // 16-byte chunks a row
constexpr size_t TILE_SMEM =
    sizeof(bf16) * ((size_t)ROWS * LDS + 2 * (size_t)KT * LDS) +
    sizeof(int) * 2 * KT;

__global__ void __launch_bounds__(NT)
mla_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ lat,
                const bf16* __restrict__ rope, const int* __restrict__ kpos,
                const int* __restrict__ offs, float* __restrict__ o, int C,
                int H, MlaStrides st, int kv_len, float sl2) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                // (ROWS, LDS)
  bf16* ks = qs + ROWS * LDS;                              // 2 × (KT, LDS)
  int* kps = reinterpret_cast<int*>(ks + 2 * KT * LDS);    // 2 × (KT,)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, half = warp >> 2;
  const int b = blockIdx.x, R = C * H, r0 = blockIdx.y * ROWS;
  const int off = offs[b];

  // this thread's two rows (fragment rows lane/4 and lane/4 + 8): token,
  // head and position (-1 for a padding row, which sees no key)
  int rt[2], rh[2], qp[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rg * 16 + (lane >> 2) + 8 * i;
    live[i] = r < R;
    rt[i] = r / H;
    rh[i] = r - rt[i] * H;
    qp[i] = live[i] ? off + rt[i] : -1;
  }

  const bf16* qb = q + b * st.qb;
  for (int c = tid; c < ROWS * CH; c += NT) {
    const int r = c / CH, ch = c - r * CH, gr = r0 + r;
    bf16* dst = qs + r * LDS + ch * 8;
    if (gr < R) {
      const int t = gr / H;
      cp_async16(dst, qb + t * st.qt + (gr - t * H) * st.qh + ch * 8);
    } else {
      zero_n<16>(dst);
    }
  }
  const bf16* lp = lat + b * st.lb;
  const bf16* rp = rope + b * st.rb;
  const int* pp = kpos + b * st.pb;
  auto load = [&](int j0, int stage) {
    bf16* kt = ks + stage * KT * LDS;
    for (int c = tid; c < KT * CH; c += NT) {
      const int j = c / CH, ch = c - j * CH, key = j0 + j;
      bf16* dst = kt + j * LDS + ch * 8;
      if (key < kv_len) {
        if (ch < DL / 8)
          cp_async16(dst, lp + key * st.ls + ch * 8);
        else
          cp_async16(dst, rp + key * st.rs + (ch - DL / 8) * 8);
      } else {   // past kv_len: zeros (V must stay finite), masked below
        zero_n<16>(dst);
      }
    }
    for (int j = tid; j < KT; j += NT)
      kps[stage * KT + j] = j0 + j < kv_len ? pp[j0 + j] : -1;
    cp_commit();
  };

  float oacc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {M_INIT, M_INIT}, l[2] = {0.f, 0.f};

  const int ntiles = (kv_len + KT - 1) / KT;
  if (ntiles > 0) {
    load(0, 0);   // one group with Q's copies
  } else {        // no key: Q's copies land before the block exits
    cp_commit();
    cp_wait<0>();
  }
  // ldmatrix row addresses: A fragments of Q and B fragments of V (.trans)
  // take matrices (rows 0-7, 8-15) × (cols 0-7, 8-15) in column order; K's
  // B fragments take them in row order
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, acol = (lane >> 4) * 8;
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
  const bf16* qw = qs + (rg * 16 + arow) * LDS + acol;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();
    __syncthreads();   // tile it landed; every warp is done with it - 1
    if (it + 1 < ntiles) load((it + 1) * KT, (it + 1) & 1);
    const bf16* kt = ks + (it & 1) * KT * LDS;
    const int* kq = kps + (it & 1) * KT;

    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DQ / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qw + kk * 16);
#pragma unroll
      for (int np = 0; np < KT / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (np * 16 + krow) * LDS + kk * 16 + kcol);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    // mask by each slot's position
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kq[n * 8 + 2 * (lane & 3) + (e & 1)];
        if (kp < 0 || kp > qp[e >> 1]) s[n][e] = -INFINITY;
      }
    // online softmax in log2 units: m is the running max of s·sl2
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx * sl2);
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = exp2f(fmaf(s[n][e], sl2, -mn));   // masked: 0
          s[n][e] = p;
          sum += p;
        }
      l[i] = l[i] * alpha + sum;   // this lane's part; quad sum at the end
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        oacc[n][2 * i] *= alpha;
        oacc[n][2 * i + 1] *= alpha;
      }
    }
    // O += P·V over this warp's 256 value columns, P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, kt + (kk * 16 + arow) * LDS + half * DH + dp * 16 + acol);
        mma_bf16(oacc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(oacc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

  // epilogue: this thread's columns 2·(lane % 4) + {0, 1} of each n-tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (!live[i]) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;   // no key: 0
    float* po = o + b * st.ob + rt[i] * st.ot + rh[i] * st.oh + half * DH +
                2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<float2*>(po + n * 8) =
          make_float2(oacc[n][2 * i] * inv, oacc[n][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------- fp32 --

constexpr int FQ = 16;                // packed rows per block
constexpr int FK = 32;                // keys per tile (a lane a key)
constexpr int FNT = 256;
constexpr int EPT = FQ * DL / FNT;    // accumulator entries a thread
constexpr size_t F32_SMEM =
    sizeof(float) * ((size_t)FQ * DQ + (size_t)FK * (DQ + 1) + FQ * FK +
                     3 * FQ) +
    sizeof(int) * (FK + FQ);

__global__ void __launch_bounds__(FNT)
mla_f32_kernel(const float* __restrict__ q, const float* __restrict__ lat,
               const float* __restrict__ rope, const int* __restrict__ kpos,
               const int* __restrict__ offs, float* __restrict__ o, int C,
               int H, MlaStrides st, int kv_len, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                     // (FQ, DQ)     scaled queries
  float* ks = qs + FQ * DQ;           // (FK, DQ + 1) keys; values: cols < DL
  float* ps = ks + FK * (DQ + 1);     // (FQ, FK)     scores → probabilities
  float* mrow = ps + FQ * FK;         // (FQ,)        running max
  float* lrow = mrow + FQ;            // (FQ,)        running sum
  float* arow = lrow + FQ;            // (FQ,)        this tile's rescale
  int* kps = reinterpret_cast<int*>(arow + FQ);   // (FK,) slot positions
  int* qps = kps + FK;                // (FQ,)        query positions
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, R = C * H, r0 = blockIdx.y * FQ;
  const int rows = min(FQ, R - r0);

  const float* qb = q + b * st.qb;
  for (int idx = tid; idx < FQ * DQ; idx += FNT) {
    const int t = idx / DQ, d = idx - t * DQ, gr = r0 + t;
    const int tok = gr / H;
    qs[idx] = t < rows ? qb[tok * st.qt + (gr - tok * H) * st.qh + d] * scale
                       : 0.f;
  }
  if (tid < FQ) {
    mrow[tid] = M_INIT;
    lrow[tid] = 0.f;
    qps[tid] = tid < rows ? offs[b] + (r0 + tid) / H : -1;
  }
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;
  const float* lp = lat + b * st.lb;
  const float* rp = rope + b * st.rb;

  for (int j0 = 0; j0 < kv_len; j0 += FK) {
    __syncthreads();   // queries ready; the previous tile fully consumed
    for (int idx = tid; idx < FK * DQ; idx += FNT) {
      const int j = idx / DQ, d = idx - j * DQ, key = j0 + j;
      float val = 0.f;
      if (key < kv_len)
        val = d < DL ? lp[key * st.ls + d] : rp[key * st.rs + d - DL];
      ks[j * (DQ + 1) + d] = val;
    }
    if (tid < FK)
      kps[tid] = j0 + tid < kv_len ? kpos[b * st.pb + j0 + tid] : -1;
    __syncthreads();
    for (int idx = tid; idx < FQ * FK; idx += FNT) {
      const int t = idx / FK, j = idx - t * FK, kp = kps[j];
      float s = -INFINITY;
      if (kp >= 0 && kp <= qps[t]) {
        float a = 0.f;
        for (int d = 0; d < DQ; ++d)
          a = fmaf(qs[t * DQ + d], ks[j * (DQ + 1) + d], a);
        s = a;
      }
      ps[idx] = s;
    }
    __syncthreads();
    // online softmax: warp w owns rows w, w + 8; lane = key
    for (int t = warp; t < FQ; t += FNT / 32) {
      const float s = ps[t * FK + lane];
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
      ps[t * FK + lane] = pe;
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
      const int idx = tid + e * FNT;
      const int t = idx / DL, d = idx - t * DL;
      float a = acc[e] * arow[t];
      for (int j = 0; j < FK; ++j)
        a = fmaf(ps[t * FK + j], ks[j * (DQ + 1) + d], a);
      acc[e] = a;
    }
  }
  __syncthreads();   // lrow final
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int idx = tid + e * FNT;
    const int t = idx / DL, d = idx - t * DL;
    if (t < rows) {
      const int gr = r0 + t, tok = gr / H;
      const float l = lrow[t];
      o[b * st.ob + tok * st.ot + (gr - tok * H) * st.oh + d] =
          l > 0.f ? acc[e] / l : 0.f;
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_args(int B, int C, int H, int kv_len) {
  return B <= 0 || C <= 0 || H <= 0 || kv_len < 0;
}

}  // namespace

// q (B, C, H, 576) bf16; latent (B, S, 512), k_rope (B, S, 64) bf16; kpos
// (B, S) int32; offs (B,) int32; o (B, C, H, 512) fp32.  strides: the 11 of
// MlaStrides.  scale: the score scale (1/sqrt(nope + rope)).
extern "C" int mla_attention_bf16(const void* q, const void* lat,
                                  const void* rope, const void* kpos,
                                  const void* offs, void* o, int B, int C,
                                  int H, const long long* strides, int kv_len,
                                  float scale, void* stream) {
  if (bad_args(B, C, H, kv_len)) return (int)cudaErrorInvalidValue;
  int err = set_smem(mla_tile_kernel, TILE_SMEM);
  if (err) return err;
  const dim3 grid(B, (C * H + ROWS - 1) / ROWS);
  mla_tile_kernel<<<grid, NT, TILE_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)lat, (const bf16*)rope, (const int*)kpos,
      (const int*)offs, (float*)o, C, H, make_strides(strides), kv_len,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

extern "C" int mla_attention_f32(const void* q, const void* lat,
                                 const void* rope, const void* kpos,
                                 const void* offs, void* o, int B, int C,
                                 int H, const long long* strides, int kv_len,
                                 float scale, void* stream) {
  if (bad_args(B, C, H, kv_len)) return (int)cudaErrorInvalidValue;
  int err = set_smem(mla_f32_kernel, F32_SMEM);
  if (err) return err;
  const dim3 grid(B, (C * H + FQ - 1) / FQ);
  mla_f32_kernel<<<grid, FNT, F32_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)lat, (const float*)rope,
      (const int*)kpos, (const int*)offs, (float*)o, C, H,
      make_strides(strides), kv_len, scale);
  return (int)cudaGetLastError();
}
