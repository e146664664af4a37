// Flash attention for Hopper (sm_90a): kernels K2 (forward), K3a (dq) and
// K3b (dk, dv) of the port.
//
// Replaces the Pallas TPU kernels of salun/kernels/flash_attention.py:
//   K2  _flash_kernel / _kernel_with_lm (via _flash_call): o = softmax(s)·v
//       with s = q·kᵀ·scale, by the online-softmax recurrence with fp32
//       running max m, denominator l and accumulator; optionally the
//       compact residual lse = m + log l ([B, Nq], as _fa_fwd_rule keeps).
//   K3a _bwd_dq_kernel:  p = exp(s − lse), dp = do·vᵀ, ds = p∘(dp − δ),
//       dq = scale · ds·k, accumulated over k-tiles.
//   K3b _bwd_dkv_kernel: dv = pᵀ·do, dk = scale · dsᵀ·q, accumulated over
//       q-tiles (one block per k-tile and split of the q walk; the splits'
//       partials are summed in a fixed order, so dk/dv need no atomics).
// δ = Σ_d do∘o is computed outside the kernels, as in JAX.
//
// Layout: single head, q [B, Nq, D], k/v [B, Nk, D], fp32, contiguous,
// 16-byte aligned; any Nq, Nk ≥ 1 (the ragged last tile is masked), any
// D that is a multiple of 8, up to 512 for K2 and 256 for K3a/K3b, Nq ≠ Nk
// allowed.
//
// K2 (`salun_flash_fwd`) replaces salun/kernels/flash_attention.py:34
// `_flash_kernel` and :136 `_kernel_with_lm`, reached through `_flash_call`
// :83. Bound: operations. It does 4·B·Nq·Nk·D flop (q·kᵀ and p·v): 137
// GFLOP at the SD VAE's [4, 4096, 4096, 512], 8.6 GFLOP on 134 MB at the
// DDPM training shape [128, 256, 256, 256], far above the ridge. In fp32
// the least time is the tensor cores' in 3xTF32: 495 TFLOP/s TF32 dense / 3
// = 165 TFLOP/s (the CUDA cores' fp32 FFMA roof is 67 TFLOP/s).
//
// K2's design against that bound:
// - Tensor cores through `mma.sync.m16n8k8` in TF32, three products per
//   step (3xTF32): each operand x splits into big = tf32(x) and small =
//   tf32(x − big), and c += a_small·b_big + a_big·b_small + a_big·b_big in
//   fp32, small terms first. That keeps K2 within about 1e-6 of fp32 (plain
//   TF32 would give ~5e-4) for both products, s = q·kᵀ and o += p·v.
// - A block takes BQ = 16·RW query rows (RW row-warps of the MMA's 16
//   rows: 64 rows up to D = 256, 32 above) and walks the keys in tiles of
//   BK (64, or 32 at 128 < D ≤ 256 so that two blocks fit an SM), with the
//   online softmax in fp32 (running max m, denominator l, α = exp(m − m'),
//   masked columns −∞; the first tile has α = exp(−∞) = 0).
// - CW column-warps share a row-warp's 16 rows (CW = 1 up to D = 128, 2 up
//   to 256, 4 above). For s they split the tile's key columns; the row max
//   and row sum are combined across them through a small shared array, and
//   p goes through shared memory, so each reads all of it. For o each owns
//   ⌈D/8/CW⌉ 8-wide column steps of the accumulator, 16·D/(32·CW) ≤ 64
//   floats a thread, in registers. The template takes the most steps a
//   warp owns (8 or 16): four instantiations in all, whatever D is.
// - q stays in shared memory. k passes in D-chunks of ≤ 64 columns and v
//   in chunks of VR rows (keys) × D, so D = 512 fits and every warp works
//   on every chunk, through a two-stage ring of 16-byte `cp.async.cg`
//   copies: the next chunk is in flight while the current one is
//   multiplied. Rows past Nq or Nk are zero-filled (src-size 0), never read.
// - Row strides keep every fragment load free of bank conflicts for any D
//   that is a multiple of 8: q, k and p rows are padded by 4 floats (a
//   stride of 4·odd floats), v rows to a stride of 8 or 24 mod 32.
// - No atomics, fixed summation order: the result is the same, bitwise,
//   from run to run. lse = m + log l is written unless its pointer is null.
// `wgmma`, TMA and warp specialisation are later work.
//
// K3a and K3b: bound operations too (6·B·Nq·Nk·D and 8·B·Nq·Nk·D flop on
// about as many bytes as K2, 64 to 128 flop per byte at the DDPM shape).
// They read the lse that K2 writes.
//
// K3a computes in plain fp32 FFMA on the CUDA cores (roof 67 TFLOP/s):
// every product is a 32×32 tile read from shared memory, where each thread
// keeps a 2×4 register tile of scores and 2 rows × D/8 columns of the
// accumulator, so each 16-byte shared-memory load feeds up to 8 FMAs.
// Rows are padded to D + 4 floats, which keeps the 16-byte loads of eight
// neighbouring rows free of bank conflicts for every D that is a multiple
// of 8. Tiles are 32 rows, so the DDPM mid block (N = 16) is one masked
// tile.
//
// K3b (`salun_flash_bwd_dkv`) replaces salun/kernels/flash_attention.py:188
// `_bwd_dkv_kernel` (called at :305 from `_fa_bwd_rule` :253). It is K2's
// loop with the roles of q and k swapped and no online softmax, since lse
// is given; its bound is the 3xTF32 roof, as K2's. Its design:
// - A block owns BK = 16·RW keys (RW row-warps of the MMA's 16 rows) and
//   keeps k and v resident in shared memory for its whole walk over the
//   query tiles. q, do, lse and δ of BQ queries a tile arrive through a
//   two-stage ring of `cp.async` copies (16-byte `.cg`; 4-byte `.ca` for
//   lse and δ, whose rows need not be 16-byte aligned), zero-filled past
//   Nq; the next tile is in flight while the current one is multiplied.
//   Two barriers a tile (one when CW = 1).
// - Phase 1: sᵀ = k·qᵀ and dpᵀ = v·doᵀ in 3xTF32 `mma.sync` (k and v the
//   A operand, qᵀ and doᵀ the B operand), then p = exp(sᵀ·scale − lse),
//   masked to 0 by column index past the walk's end, and ds = p∘(dpᵀ − δ).
//   With CW = 1 a warp computes both for all the tile's queries, in
//   registers. With CW > 1, half the column-warps of a row-warp compute sᵀ
//   and write p, the other half dpᵀ and write dpᵀ − δ, each over a share
//   of the query columns, so a warp loads and splits one resident A
//   fragment a step, not two; pᵀ and (dpᵀ − δ) go through shared memory.
// - Phase 2: dv += pᵀ·do and dk += dsᵀ·q, the B operand do or q read
//   row-major. Its k slots (queries) are taken in the order 2t, 2t + 1
//   (see `load_b_pairs`), so with CW = 1 the A operand is phase 1's C
//   fragment, still in the warp's registers; with CW > 1 it is read from
//   shared memory, ds formed as it is read. Each column-warp owns
//   ⌈D/8/CW⌉ 8-wide column steps of both accumulators, 2·16·D/(32·CW) ≤ 64
//   floats a thread.
// - The instantiations trade registers for resident warps, which hide the
//   MMA and load latencies: BK = 64 keys, BQ = 32 queries and CW = 1 with
//   4 blocks an SM up to D = 40 (SD's level 0), 3 up to 64; CW = 2 and 2
//   blocks up to 128; BK = BQ = 32, CW = 4 and one block up to 256, whose
//   k, v and ring fill 210 KB of shared memory at D = 256.
// - Every fragment read is free of bank conflicts with rows of d + 4
//   floats (a stride of 4·odd), pᵀ and dsᵀ rows of BQ + 8.
// - Where B·⌈Nk/BK⌉ blocks would leave SMs idle (SD cross-attention, Nk =
//   77), the host cuts each block's query walk into contiguous splits, one
//   block each; the splits write unscaled partials to a workspace and a
//   second kernel sums them in a fixed order and applies dk's scale.
// - No atomics, fixed summation order: dk and dv are the same, bitwise,
//   from run to run. dk·scale is applied once, at the end.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TILE = 32;       // rows of a q-tile and of a k-tile
constexpr int LANES = 8;       // threads that share one row of a tile
constexpr int SLD = TILE + 1;  // row stride of a score tile in smem
constexpr int MAX_D_FWD = 512;  // K2
constexpr int MAX_D_BWD = 256;  // K3a, K3b

__host__ __device__ constexpr int row_stride(int d) { return d + 4; }

// Rows [row0, row0 + TILE) of the row-major [n, d] matrix `src` into
// shared memory (row stride d + 4); rows at or past n are zero.
template <int THREADS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n, int d) {
  const int d4 = d / 4;
  const int ld = row_stride(d);
  for (int idx = threadIdx.x; idx < TILE * d4; idx += THREADS) {
    const int r = idx / d4;
    const int c = idx - r * d4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) {
      val = __ldg(reinterpret_cast<const float4*>(
                      src + (int64_t)(row0 + r) * d) + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = val;
  }
}

// s[r][j] = Σ_c a[ty + r·G][c] · b[tx + 8j][c] over the d columns of two
// shared-memory tiles, G = TILE / R: the thread's rows of a 32×32 score
// tile.
template <int R>
__device__ __forceinline__ void score_tile(float (&s)[R][4], const float* a,
                                           const float* b, int d, int ty,
                                           int tx) {
  constexpr int G = TILE / R;
  const int ld = row_stride(d);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
  }
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
    float4 av[R], bv[4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      av[r] = *reinterpret_cast<const float4*>(a + (ty + r * G) * ld + c);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + LANES * j) * ld + c);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = s[r][j];
        acc = fmaf(av[r].x, bv[j].x, acc);
        acc = fmaf(av[r].y, bv[j].y, acc);
        acc = fmaf(av[r].z, bv[j].z, acc);
        acc = fmaf(av[r].w, bv[j].w, acc);
        s[r][j] = acc;
      }
    }
  }
}

// acc[r][g] += Σ_j p[ty + r·G][j] · b[j][4(tx + 8g) .. +3] over the TILE
// rows of the shared-memory tile b; p is a score tile (row stride SLD).
template <int R, int NG>
__device__ __forceinline__ void accum_tile(float4 (&acc)[R][NG],
                                           const float* p, const float* b,
                                           int d, int ty, int tx) {
  constexpr int G = TILE / R;
  const int ld = row_stride(d);
  const int d4 = d / 4;
#pragma unroll 4
  for (int j = 0; j < TILE; ++j) {
    float pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) pv[r] = p[(ty + r * G) * SLD + j];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c4 = tx + LANES * g;
      if (c4 < d4) {
        const float4 bv = *reinterpret_cast<const float4*>(b + j * ld + 4 * c4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][g].x = fmaf(pv[r], bv.x, acc[r][g].x);
          acc[r][g].y = fmaf(pv[r], bv.y, acc[r][g].y);
          acc[r][g].z = fmaf(pv[r], bv.z, acc[r][g].z);
          acc[r][g].w = fmaf(pv[r], bv.w, acc[r][g].w);
        }
      }
    }
  }
}

template <int R, int NG>
__device__ __forceinline__ void zero(float4 (&acc)[R][NG]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[r][g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The thread's rows of acc into rows [row0, row0 + TILE) of the [n, d]
// matrix dst, each multiplied by mul[r]; rows at or past n are skipped.
template <int R, int NG>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float4 (&acc)[R][NG],
                                           const float (&mul)[R], int row0,
                                           int n, int d, int ty, int tx) {
  constexpr int G = TILE / R;
  const int d4 = d / 4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + ty + r * G;
    if (row >= n) continue;
    float4* out = reinterpret_cast<float4*>(dst + (int64_t)row * d);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c4 = tx + LANES * g;
      if (c4 < d4) {
        out[c4] = make_float4(acc[r][g].x * mul[r], acc[r][g].y * mul[r],
                              acc[r][g].z * mul[r], acc[r][g].w * mul[r]);
      }
    }
  }
}

// Reductions over the 8 threads of a row: they are 8 neighbouring lanes.
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

__host__ __device__ constexpr int threads_for(int r) {
  return LANES * TILE / r;
}

// ------------------------------------------------------------------ K2

// Tensor-core parts: 3xTF32 `mma.sync` fragments and the `cp.async` ring.

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x ≈ big + small, both TF32 (about 22 bits of x's 24).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// m16n8k8 fragments, split for 3xTF32. With g = lane / 4, t = lane % 4:
// A (16×8, row-major) a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// B (8×8) b0 (k = t, n = g), b1 (k = t+4, n = g);
// C (16×8) c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// A from a row-major tile: base at (row 0, col 0), row stride ld.
__device__ __forceinline__ void load_a(FragA& f, const float* base, int ld,
                                       int g, int t) {
  split_tf32(base[g * ld + t], f.big[0], f.small[0]);
  split_tf32(base[(g + 8) * ld + t], f.big[1], f.small[1]);
  split_tf32(base[g * ld + t + 4], f.big[2], f.small[2]);
  split_tf32(base[(g + 8) * ld + t + 4], f.big[3], f.small[3]);
}

// B = Xᵀ for a row-major X [n][k] (k for s = q·kᵀ).
__device__ __forceinline__ void load_b_t(FragB& f, const float* base, int ld,
                                         int g, int t) {
  split_tf32(base[g * ld + t], f.big[0], f.small[0]);
  split_tf32(base[g * ld + t + 4], f.big[1], f.small[1]);
}

// B = X for a row-major X [k][n] (v for o += p·v).
__device__ __forceinline__ void load_b(FragB& f, const float* base, int ld,
                                       int g, int t) {
  split_tf32(base[t * ld + g], f.big[0], f.small[0]);
  split_tf32(base[(t + 4) * ld + g], f.big[1], f.small[1]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// 16 bytes global → shared, asynchronously; zero-filled (nothing read)
// unless `valid`.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) × columns [col0, col0 + w) of the row-major
// [n, d] matrix `src` into `dst` (row stride ld), asynchronously; rows at
// or past n are zero.
template <int THREADS>
__device__ __forceinline__ void copy_rows_async(float* dst, int ld,
                                                const float* src, int row0,
                                                int rows, int n, int d,
                                                int col0, int w) {
  const int w4 = w / 4;
  for (int idx = threadIdx.x; idx < rows * w4; idx += THREADS) {
    const int r = idx / w4;
    const int c = idx - r * w4;
    const bool ok = row0 + r < n;
    const float* from = ok ? src + (int64_t)(row0 + r) * d + col0 + 4 * c
                           : src;
    cp_async16(dst + r * ld + 4 * c, from, ok);
  }
}

// Shared-memory layout of K2 (in floats), the same on host and device.
// k passes in chunks of ≤ 64 columns (row stride dc + 4), v in chunks of
// vr rows (row stride ldv ≡ 8 or 24 mod 32, so that the B loads of v are
// free of bank conflicts); one ring stage holds either.
__host__ __device__ constexpr int fwd_dc(int d) { return d < 64 ? d : 64; }
__host__ __device__ constexpr int fwd_ldv(int d) {
  return d + (d % 16 == 0 ? 8 : 0);
}
__host__ __device__ inline int fwd_vr(int d, int bk) {
  int vr = bk;
  while (vr > 8 && vr * fwd_ldv(d) > bk * (fwd_dc(d) + 4)) vr /= 2;
  return vr;
}
__host__ __device__ inline int fwd_stage(int d, int bk) {
  const int k_chunk = bk * (fwd_dc(d) + 4);
  const int v_chunk = fwd_vr(d, bk) * fwd_ldv(d);
  return k_chunk > v_chunk ? k_chunk : v_chunk;
}

template <int RW, int CW, int BK>
size_t fwd_smem(int d) {
  constexpr int BQ = 16 * RW;
  const int red = CW > 1 ? 2 * RW * CW * 16 : 0;
  return sizeof(float) *
         (BQ * row_stride(d) + 2 * fwd_stage(d, BK) + BQ * (BK + 4) + red);
}

// RW row-warps × CW column-warps; BK keys per tile; NS the most 8-wide
// output column steps a warp owns (see the note at the top).
template <int RW, int CW, int BK, int NS>
__global__ void __launch_bounds__(RW * CW * 32, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int nq, int nk, int d,
                 float scale) {
  constexpr int THREADS = RW * CW * 32;
  constexpr int BQ = 16 * RW;
  constexpr int NJ = BK / 8 / CW;  // 8-wide key steps of a warp's s
  constexpr int LDP = BK + 4;
  static_assert(NJ >= 1 && BK % (8 * CW) == 0, "key tile");

  const int ldq = row_stride(d);
  const int dc = fwd_dc(d);
  const int ldk = dc + 4;
  const int ldv = fwd_ldv(d);
  const int vr = fwd_vr(d, BK);
  const int stage = fwd_stage(d, BK);
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* ring = q_s + BQ * ldq;
  float* p_s = ring + 2 * stage;
  float* red_max = p_s + BQ * LDP;  // [RW][CW][16], used when CW > 1
  float* red_sum = red_max + RW * CW * 16;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rw = warp / CW;
  const int cw = warp % CW;

  const int n_qt = (nq + BQ - 1) / BQ;
  const int b = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - b * n_qt) * BQ;
  q += (int64_t)b * nq * d;
  o += (int64_t)b * nq * d;
  k += (int64_t)b * nk * d;
  v += (int64_t)b * nk * d;

  // the ring's sequence of loads: per key tile n_kc k-chunks, then n_vc
  // v-chunks
  const int n_kc = (d + dc - 1) / dc;
  const int n_vc = BK / vr;
  const int per_tile = n_kc + n_vc;
  const int n_tiles = (nk + BK - 1) / BK;
  const int total = n_tiles * per_tile;

  auto issue = [&](int i) {
    float* dst = ring + (i & 1) * stage;
    const int tile = i / per_tile;
    const int r = i - tile * per_tile;
    if (r < n_kc) {
      const int c0 = r * dc;
      copy_rows_async<THREADS>(dst, ldk, k, tile * BK, BK, nk, d, c0,
                               min(dc, d - c0));
    } else {
      copy_rows_async<THREADS>(dst, ldv, v, tile * BK + (r - n_kc) * vr, vr,
                               nk, d, 0, d);
    }
    cp_async_commit();
  };
  int next = 0;  // the load the block works on
  // waits for load `next`, with load next + 1 put in flight first
  auto acquire = [&]() -> const float* {
    if (next + 1 < total) {
      issue(next + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    return ring + (next & 1) * stage;
  };
  // every warp is done with load `next`: its stage may be refilled
  auto release = [&]() {
    __syncthreads();
    ++next;
  };

  copy_rows_async<THREADS>(q_s, ldq, q, q0, BQ, nq, d, 0, d);
  issue(0);  // one group with the q tile

  // the warp's 8-wide output column steps: [j0, j0 + ns)
  const int steps = d / 8;
  const int per_warp = (steps + CW - 1) / CW;
  const int j0 = cw * per_warp;
  const int ns = max(0, min(per_warp, steps - j0));
  const int key0 = cw * NJ * 8;  // the warp's first key column of a tile
  const float* q_w = q_s + rw * 16 * ldq;
  float* p_w = p_s + rw * 16 * LDP;

  float acc[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    for (int kc = 0; kc < n_kc; ++kc) {
      const float* k_s = acquire();
      const int c0 = kc * dc;
      const int w = min(dc, d - c0);
      for (int kk = 0; kk < w; kk += 8) {
        FragA a;
        load_a(a, q_w + c0 + kk, ldq, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB bf;
          load_b_t(bf, k_s + (key0 + 8 * j) * ldk + kk, ldk, g, t);
          mma_3xtf32(s[j], a, bf);
        }
      }
      release();
    }

    // online softmax of the tile: scale, mask, row max over all CW warps
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + key0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = col < nk ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if constexpr (CW > 1) {
      float* mine = red_max + (rw * CW + cw) * 16;
      if (t == 0) {
        mine[g] = mx[0];
        mine[g + 8] = mx[1];
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = -INFINITY;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          mx[h] = fmaxf(mx[h], red_max[(rw * CW + c) * 16 + g + 8 * h]);
        }
      }
    }
    // every key tile holds a valid column, so the new max is finite
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = expf(s[j][2 * h] - m[h]);
        const float p1 = expf(s[j][2 * h + 1] - m[h]);
        sum[h] += p0 + p1;
        *reinterpret_cast<float2*>(p_w + (g + 8 * h) * LDP + key0 + 8 * j +
                                   2 * t) = make_float2(p0, p1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    }
    if constexpr (CW > 1) {
      if (t == 0) {
        red_sum[(rw * CW + cw) * 16 + g] = sum[0];
        red_sum[(rw * CW + cw) * 16 + g + 8] = sum[1];
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // o += p·v over the tile's v-chunks; the first acquire's barrier also
    // publishes p and the row sums
    for (int vc = 0; vc < n_vc; ++vc) {
      const float* v_s = acquire();
      if (vc == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tot = sum[h];
          if constexpr (CW > 1) {
            tot = 0.f;
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              tot += red_sum[(rw * CW + c) * 16 + g + 8 * h];
            }
          }
          l[h] = l[h] * alpha[h] + tot;
        }
      }
      for (int kk = 0; kk < vr; kk += 8) {
        FragA a;
        load_a(a, p_w + vc * vr + kk, LDP, g, t);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          if (j < ns) {
            FragB bf;
            load_b(bf, v_s + kk * ldv + 8 * (j0 + j), ldv, g, t);
            mma_3xtf32(acc[j], a, bf);
          }
        }
      }
      release();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + rw * 16 + g + 8 * h;
    if (row >= nq) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (j < ns) {
        *reinterpret_cast<float2*>(o + (int64_t)row * d + 8 * (j0 + j) +
                                   2 * t) =
            make_float2(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
      }
    }
    if (lse != nullptr && cw == 0 && t == 0) {
      lse[(int64_t)b * nq + row] = m[h] + logf(l[h]);
    }
  }
}

// ------------------------------------------------------------------ K3a

constexpr int DQ_R = 2;

size_t dq_smem(int d) {
  return sizeof(float) * (4 * TILE * row_stride(d) + TILE * SLD);
}

template <int R, int NG>
__global__ void __launch_bounds__(threads_for(R))
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int nq, int nk, int d, float scale) {
  constexpr int THREADS = threads_for(R);
  constexpr int G = TILE / R;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + TILE * row_stride(d);
  float* k_s = do_s + TILE * row_stride(d);
  float* v_s = k_s + TILE * row_stride(d);
  float* ds_s = v_s + TILE * row_stride(d);

  const int n_qt = (nq + TILE - 1) / TILE;
  const int b = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - b * n_qt) * TILE;
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  q += (int64_t)b * nq * d;
  dout += (int64_t)b * nq * d;
  dq += (int64_t)b * nq * d;
  k += (int64_t)b * nk * d;
  v += (int64_t)b * nk * d;

  load_tile<THREADS>(q_s, q, q0, nq, d);
  load_tile<THREADS>(do_s, dout, q0, nq, d);
  float lse_r[R], dl_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + ty + r * G;
    lse_r[r] = row < nq ? lse[(int64_t)b * nq + row] : 0.f;
    dl_r[r] = row < nq ? delta[(int64_t)b * nq + row] : 0.f;
  }
  float4 acc[R][NG];
  zero(acc);

  for (int k0 = 0; k0 < nk; k0 += TILE) {
    __syncthreads();
    load_tile<THREADS>(k_s, k, k0, nk, d);
    load_tile<THREADS>(v_s, v, k0, nk, d);
    __syncthreads();
    float s[R][4], dp[R][4];
    score_tile<R>(s, q_s, k_s, d, ty, tx);
    score_tile<R>(dp, do_s, v_s, d, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = k0 + tx + LANES * j < nk;
        const float p = valid ? expf(s[r][j] * scale - lse_r[r]) : 0.f;
        ds_s[(ty + r * G) * SLD + tx + LANES * j] = p * (dp[r][j] - dl_r[r]);
      }
    }
    __syncthreads();
    accum_tile<R, NG>(acc, ds_s, k_s, d, ty, tx);
  }

  float mul[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mul[r] = scale;
  store_rows<R, NG>(dq, acc, mul, q0, nq, d, ty, tx);
}

// ------------------------------------------------------------------ K3b

// Phase 2 multiplies over a tile's queries, the MMA's k dimension. Its k
// slots t and t + 4 of each 8-query step are given the queries 2t and
// 2t + 1, an order the sum does not see. Then the A fragment a0…a3 is the
// C fragment c0, c2, c1, c3 of phase 1's sᵀ (the same thread holds it),
// and both B reads of a q or do tile with rows of d + 4 floats, Xᵀ in
// phase 1 (`load_b_t`) and X here, are free of bank conflicts.

// A fragments of p and of p∘x from the row-major tiles p and x in that
// order: (g, 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1), as 8-byte loads.
__device__ __forceinline__ void load_a_pairs(FragA& fp, FragA& fpx,
                                             const float* p, const float* x,
                                             int ld, int g, int t) {
  const float2 p_lo = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  const float2 p_hi =
      *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
  const float2 x_lo = *reinterpret_cast<const float2*>(x + g * ld + 2 * t);
  const float2 x_hi =
      *reinterpret_cast<const float2*>(x + (g + 8) * ld + 2 * t);
  split_tf32(p_lo.x, fp.big[0], fp.small[0]);
  split_tf32(p_hi.x, fp.big[1], fp.small[1]);
  split_tf32(p_lo.y, fp.big[2], fp.small[2]);
  split_tf32(p_hi.y, fp.big[3], fp.small[3]);
  split_tf32(p_lo.x * x_lo.x, fpx.big[0], fpx.small[0]);
  split_tf32(p_hi.x * x_hi.x, fpx.big[1], fpx.small[1]);
  split_tf32(p_lo.y * x_lo.y, fpx.big[2], fpx.small[2]);
  split_tf32(p_hi.y * x_hi.y, fpx.big[3], fpx.small[3]);
}

// A from a C fragment c of the same 16 × 8 tile.
__device__ __forceinline__ void frag_a_from_c(FragA& f, const float (&c)[4]) {
  split_tf32(c[0], f.big[0], f.small[0]);
  split_tf32(c[2], f.big[1], f.small[1]);
  split_tf32(c[1], f.big[2], f.small[2]);
  split_tf32(c[3], f.big[3], f.small[3]);
}

// B = X for a row-major X [k][n] in that order: rows k0 + 2t and
// k0 + 2t + 1, column n0 + g.
__device__ __forceinline__ void load_b_pairs(FragB& f, const float* x,
                                             int ld, int k0, int n0, int g,
                                             int t) {
  split_tf32(x[(k0 + 2 * t) * ld + n0 + g], f.big[0], f.small[0]);
  split_tf32(x[(k0 + 2 * t + 1) * ld + n0 + g], f.big[1], f.small[1]);
}

// 4 bytes global → shared, asynchronously (through L1: `.cg` takes only
// 16); zero-filled (nothing read) unless `valid`.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Shared-memory layout of K3b (in floats), the same on host and device:
// k and v resident (BK rows), a two-stage ring of {q, do (BQ rows), lse,
// δ (BQ each)}, rows of d + 4 floats; with CW > 1, pᵀ and dsᵀ
// [BK][BQ + 8] (a stride ≡ 8 mod 32: the 8-byte stores and loads of a
// half-warp fall on distinct banks).
template <int BQ>
__host__ __device__ constexpr int dkv_stage(int d) {
  return 2 * BQ * row_stride(d) + 2 * BQ;
}

template <int RW, int CW, int BQ>
__host__ __device__ constexpr size_t dkv_smem(int d) {
  return sizeof(float) * (2 * 16 * RW * row_stride(d) +
                          2 * dkv_stage<BQ>(d) +
                          (CW > 1 ? 2 * 16 * RW * (BQ + 8) : 0));
}

// RW row-warps × CW column-warps; BQ queries per tile; NS the most 8-wide
// output column steps a warp owns; MINB the blocks per SM the registers
// must allow (see the note at the top). Block (blockIdx.x = b · ⌈nk/BK⌉ +
// k-tile, blockIdx.y = split) walks the query rows [split ·
// rows_per_split, + rows_per_split) and writes its dk (times dk_mul) and
// dv to dk, dv + split · split_stride.
template <int RW, int CW, int BQ, int NS, int MINB>
__global__ void __launch_bounds__(RW * CW * 32, MINB)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int nq,
                     int nk, int d, int rows_per_split, int64_t split_stride,
                     float dk_mul, float scale) {
  constexpr int THREADS = RW * CW * 32;
  constexpr int BK = 16 * RW;
  constexpr int NJ = BQ / 8;  // 8-wide query steps of a tile
  constexpr int LDP = BQ + 8;
  static_assert(BQ % 8 == 0 && (CW == 1 || (CW % 2 == 0 &&
                                            NJ % (CW / 2) == 0)),
                "query tile");

  const int ld = row_stride(d);
  const int stage = dkv_stage<BQ>(d);
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + BK * ld;
  float* ring = v_s + BK * ld;
  float* p_s = ring + 2 * stage;  // CW > 1 only
  float* ds_s = p_s + BK * LDP;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rw = warp / CW;
  const int cw = warp % CW;

  const int n_kt = (nk + BK - 1) / BK;
  const int b = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - b * n_kt) * BK;
  const int q_begin = blockIdx.y * rows_per_split;
  const int q_end = min(nq, q_begin + rows_per_split);
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  q += (int64_t)b * nq * d;
  dout += (int64_t)b * nq * d;
  lse += (int64_t)b * nq;
  delta += (int64_t)b * nq;
  k += (int64_t)b * nk * d;
  v += (int64_t)b * nk * d;
  dk += blockIdx.y * split_stride + (int64_t)b * nk * d;
  dv += blockIdx.y * split_stride + (int64_t)b * nk * d;

  // query tile i of the walk into ring stage i & 1, one cp.async group
  auto fetch = [&](int i) {
    float* st = ring + (i & 1) * stage;
    const int q0 = q_begin + i * BQ;
    copy_rows_async<THREADS>(st, ld, q, q0, BQ, nq, d, 0, d);
    copy_rows_async<THREADS>(st + BQ * ld, ld, dout, q0, BQ, nq, d, 0, d);
    float* vec = st + 2 * BQ * ld;
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool ok = q0 + r < nq;
      cp_async4(vec + r, ok ? lse + q0 + r : lse, ok);
      cp_async4(vec + BQ + r, ok ? delta + q0 + r : delta, ok);
    }
    cp_async_commit();
  };

  copy_rows_async<THREADS>(k_s, ld, k, k0, BK, nk, d, 0, d);
  copy_rows_async<THREADS>(v_s, ld, v, k0, BK, nk, d, 0, d);
  cp_async_commit();
  if (n_tiles > 0) fetch(0);

  // phase 2: the warp's 16 keys × the 8-wide output column steps
  // [j0, j0 + ns) of dk and dv
  const int steps = d / 8;
  const int per_warp = (steps + CW - 1) / CW;
  const int j0 = cw * per_warp;
  const int ns = max(0, min(per_warp, steps - j0));
  const float* k_w = k_s + rw * 16 * ld;
  const float* v_w = v_s + rw * 16 * ld;
  float* p_w = p_s + rw * 16 * LDP;
  float* ds_w = ds_s + rw * 16 * LDP;

  float acc_k[NS][4], acc_v[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[j][e] = 0.f;
      acc_v[j][e] = 0.f;
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed and every warp is done with tile i − 1: its stage
    // may be refilled with tile i + 1 (and pᵀ, dsᵀ rewritten)
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_tiles) fetch(i + 1);
    const float* q_t = ring + (i & 1) * stage;
    const float* do_t = q_t + BQ * ld;
    const float* lse_t = do_t + BQ * ld;
    const float* dl_t = lse_t + BQ;
    const int q0 = q_begin + i * BQ;

    if constexpr (CW == 1) {
      // phase 1: sᵀ = k·qᵀ and dpᵀ = v·doᵀ, then in place p = exp(sᵀ·
      // scale − lse) and ds = p∘(dpᵀ − δ) by query column; 0 at and past
      // the walk's end (a zero-filled row has s = 0 and lse = 0)
      float p[NJ][4], ds[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = 0.f;
          ds[j][e] = 0.f;
        }
      }
      for (int kk = 0; kk < d; kk += 8) {
        FragA ak, av;
        load_a(ak, k_w + kk, ld, g, t);
        load_a(av, v_w + kk, ld, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB bf;
          load_b_t(bf, q_t + (8 * j) * ld + kk, ld, g, t);
          mma_3xtf32(p[j], ak, bf);
          load_b_t(bf, do_t + (8 * j) * ld + kk, ld, g, t);
          mma_3xtf32(ds[j], av, bf);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const float pv =
              q0 + c < q_end ? expf(p[j][e] * scale - lse_t[c]) : 0.f;
          ds[j][e] = pv * (ds[j][e] - dl_t[c]);
          p[j][e] = pv;
        }
      }

      // phase 2: dv += pᵀ·do and dk += dsᵀ·q over the tile's BQ queries;
      // the warp holds all BQ columns of its 16 rows
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragA ap, ad;
        frag_a_from_c(ap, p[j]);
        frag_a_from_c(ad, ds[j]);
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
          if (jj < ns) {
            FragB bf;
            load_b_pairs(bf, do_t, ld, 8 * j, 8 * (j0 + jj), g, t);
            mma_3xtf32(acc_v[jj], ap, bf);
            load_b_pairs(bf, q_t, ld, 8 * j, 8 * (j0 + jj), g, t);
            mma_3xtf32(acc_k[jj], ad, bf);
          }
        }
      }
    } else {
      // phase 1, one product a warp: the first CW/2 column-warps of a
      // row-warp compute sᵀ = k·qᵀ and write p = exp(sᵀ·scale − lse) (0 at
      // and past the walk's end), the others dpᵀ = v·doᵀ and write dpᵀ − δ,
      // each over NX 8-query steps
      constexpr int NX = NJ / (CW / 2);
      const bool is_s = cw < CW / 2;
      const int xc0 = (cw % (CW / 2)) * NX * 8;
      const float* a_w = is_s ? k_w : v_w;
      const float* b_t = is_s ? q_t : do_t;
      float x[NX][4];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
      }
      for (int kk = 0; kk < d; kk += 8) {
        FragA af;
        load_a(af, a_w + kk, ld, g, t);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          FragB bf;
          load_b_t(bf, b_t + (xc0 + 8 * j) * ld + kk, ld, g, t);
          mma_3xtf32(x[j], af, bf);
        }
      }
      float* x_w = is_s ? p_w : ds_w;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = xc0 + 8 * j + 2 * t;
          float v0 = x[j][2 * h];
          float v1 = x[j][2 * h + 1];
          if (is_s) {
            v0 = q0 + c < q_end ? expf(v0 * scale - lse_t[c]) : 0.f;
            v1 = q0 + c + 1 < q_end ? expf(v1 * scale - lse_t[c + 1]) : 0.f;
          } else {
            v0 -= dl_t[c];
            v1 -= dl_t[c + 1];
          }
          *reinterpret_cast<float2*>(x_w + (g + 8 * h) * LDP + c) =
              make_float2(v0, v1);
        }
      }
      __syncthreads();

      // phase 2: dv += pᵀ·do and dk += dsᵀ·q, ds = p∘(dpᵀ − δ)
#pragma unroll 2
      for (int kk = 0; kk < BQ; kk += 8) {
        FragA ap, ad;
        load_a_pairs(ap, ad, p_w + kk, ds_w + kk, LDP, g, t);
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
          if (jj < ns) {
            FragB bf;
            load_b_pairs(bf, do_t, ld, kk, 8 * (j0 + jj), g, t);
            mma_3xtf32(acc_v[jj], ap, bf);
            load_b_pairs(bf, q_t, ld, kk, 8 * (j0 + jj), g, t);
            mma_3xtf32(acc_k[jj], ad, bf);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // k and v, when the walk is empty

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + rw * 16 + g + 8 * h;
    if (row >= nk) continue;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (j < ns) {
        const int64_t at = (int64_t)row * d + 8 * (j0 + j) + 2 * t;
        *reinterpret_cast<float2*>(dk + at) = make_float2(
            acc_k[j][2 * h] * dk_mul, acc_k[j][2 * h + 1] * dk_mul);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
      }
    }
  }
}

// The split walk's partials [splits][n4] (float4s) summed in the order
// s = 0 … splits − 1: dk = scale · Σ, dv = Σ.
__global__ void __launch_bounds__(256)
flash_bwd_dkv_reduce_kernel(const float4* __restrict__ part_k,
                            const float4* __restrict__ part_v,
                            float4* __restrict__ dk, float4* __restrict__ dv,
                            int splits, int64_t n4, float scale) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 sk = part_k[i];
    float4 sv = part_v[i];
    for (int s = 1; s < splits; ++s) {
      const float4 a = part_k[s * n4 + i];
      const float4 c = part_v[s * n4 + i];
      sk = make_float4(sk.x + a.x, sk.y + a.y, sk.z + a.z, sk.w + a.w);
      sv = make_float4(sv.x + c.x, sv.y + c.y, sv.z + c.z, sv.w + c.w);
    }
    dk[i] = make_float4(sk.x * scale, sk.y * scale, sk.z * scale,
                        sk.w * scale);
    dv[i] = sv;
  }
}

// ------------------------------------------------------------- launchers

bool shape_ok(int batch, int nq, int nk, int d, int max_d) {
  return batch >= 1 && nq >= 1 && nk >= 1 && d >= 8 && d <= max_d &&
         d % 8 == 0;
}

int64_t grid_for(int batch, int n) {
  return (int64_t)batch * ((n + TILE - 1) / TILE);
}

// Sets the kernel's dynamic shared memory limit and launches it; returns
// the first CUDA error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, int64_t blocks, size_t smem,
           void* stream, Args... args) {
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// `launch` with a two-dimensional grid.
template <typename Kernel, typename... Args>
int launch_grid(Kernel kernel, int threads, dim3 grid, size_t smem,
                void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return (int)cudaGetLastError();
}

template <int RW, int CW, int BK, int NS>
int fwd_launch(const float* q, const float* k, const float* v, float* o,
               float* lse, int batch, int nq, int nk, int d, float scale,
               void* stream) {
  const int64_t blocks = (int64_t)batch * ((nq + 16 * RW - 1) / (16 * RW));
  return launch(flash_fwd_kernel<RW, CW, BK, NS>, RW * CW * 32, blocks,
                fwd_smem<RW, CW, BK>(d), stream, q, k, v, o, lse, nq, nk, d,
                scale);
}

template <int NG>
int dq_ng(const float* q, const float* k, const float* v, const float* dout,
          const float* lse, const float* delta, float* dq, int batch, int nq,
          int nk, int d, float scale, void* stream) {
  return launch(flash_bwd_dq_kernel<DQ_R, NG>, threads_for(DQ_R),
                grid_for(batch, nq), dq_smem(d), stream, q, k, v, dout, lse,
                delta, dq, nq, nk, d, scale);
}

// K3b over ⌈nq / rows_per_split⌉ splits of the query walk. One split
// writes dk, dv directly; more write their unscaled partials to `work`
// ([2][splits][batch · nk · d]: dk's, then dv's) and a second kernel sums
// them in a fixed order.
template <int RW, int CW, int BQ, int NS, int MINB>
int dkv_launch(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, float* work, int batch, int nq, int nk,
               int d, int rows_per_split, float scale, void* stream) {
  if (rows_per_split < BQ || rows_per_split % BQ != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int splits = (nq + rows_per_split - 1) / rows_per_split;
  if (splits > 65535 || (splits > 1 && work == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t per_split = (int64_t)batch * nk * d;
  const int64_t blocks = (int64_t)batch * ((nk + 16 * RW - 1) / (16 * RW));
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  float* out_k = splits > 1 ? work : dk;
  float* out_v = splits > 1 ? work + splits * per_split : dv;
  int err = launch_grid(flash_bwd_dkv_kernel<RW, CW, BQ, NS, MINB>,
                        RW * CW * 32,
                        dim3((unsigned)blocks, (unsigned)splits),
                        dkv_smem<RW, CW, BQ>(d), stream, q, k, v, dout, lse,
                        delta, out_k, out_v, nq, nk, d, rows_per_split,
                        per_split, splits > 1 ? 1.f : scale, scale);
  if (err != 0 || splits == 1) return err;
  const int64_t n4 = per_split / 4;
  const int64_t reduce_blocks = std::min<int64_t>((n4 + 255) / 256, 8192);
  return launch_grid(flash_bwd_dkv_reduce_kernel, 256,
                     dim3((unsigned)reduce_blocks), 0, stream,
                     reinterpret_cast<const float4*>(work),
                     reinterpret_cast<const float4*>(work +
                                                     splits * per_split),
                     reinterpret_cast<float4*>(dk),
                     reinterpret_cast<float4*>(dv), splits, n4, scale);
}

// Resident blocks of K3b per SM at head width d, or −1.
template <int RW, int CW, int BQ, int NS, int MINB>
int dkv_blocks_per_sm(int d) {
  const auto kernel = flash_bwd_dkv_kernel<RW, CW, BQ, NS, MINB>;
  const size_t smem = dkv_smem<RW, CW, BQ>(d);
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, RW * CW * 32,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

// K3b's instantiation by D range: row-warps (BK = 16·RW keys), column-
// warps, queries per tile, most column steps per warp, blocks per SM the
// registers must allow. The split plan of
// salun_torch/kernels/flash_attention.py (DKV_TILES) mirrors BK and BQ.
#define SALUN_DKV_CONFIG(d, FN, ...)                         \
  ((d) <= 40    ? FN<4, 1, 32, 5, 4>(__VA_ARGS__)            \
   : (d) <= 64  ? FN<4, 1, 32, 8, 3>(__VA_ARGS__)            \
   : (d) <= 128 ? FN<4, 2, 32, 8, 2>(__VA_ARGS__)            \
                : FN<2, 4, 32, 8, 1>(__VA_ARGS__))

// NG = ceil(d / 32) float4 column groups per thread, a template argument
// so the accumulators stay in registers.
#define SALUN_DISPATCH_NG(d, FN, ...)        \
  switch (((d) + 31) / 32) {                 \
    case 1: return FN<1>(__VA_ARGS__);       \
    case 2: return FN<2>(__VA_ARGS__);       \
    case 3: return FN<3>(__VA_ARGS__);       \
    case 4: return FN<4>(__VA_ARGS__);       \
    case 5: return FN<5>(__VA_ARGS__);       \
    case 6: return FN<6>(__VA_ARGS__);       \
    case 7: return FN<7>(__VA_ARGS__);       \
    case 8: return FN<8>(__VA_ARGS__);       \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape the kernels do not take).

// K2: o [B, Nq, D]; lse [B, Nq] is written unless it is null.
extern "C" int salun_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int batch, int nq, int nk,
                               int d, float scale, void* stream) {
  if (!shape_ok(batch, nq, nk, d, MAX_D_FWD)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(o);
  float* lp = static_cast<float*>(lse);
  // row-warps, column-warps, keys per tile, most column steps per warp
  if (d <= 64) {
    return fwd_launch<4, 1, 64, 8>(qp, kp, vp, op, lp, batch, nq, nk, d,
                                   scale, stream);
  }
  if (d <= 128) {
    return fwd_launch<4, 1, 64, 16>(qp, kp, vp, op, lp, batch, nq, nk, d,
                                    scale, stream);
  }
  if (d <= 256) {
    return fwd_launch<4, 2, 32, 16>(qp, kp, vp, op, lp, batch, nq, nk, d,
                                    scale, stream);
  }
  return fwd_launch<2, 4, 64, 16>(qp, kp, vp, op, lp, batch, nq, nk, d,
                                  scale, stream);
}

// K3a: dq [B, Nq, D] from q, k, v, do, lse [B, Nq] and delta [B, Nq].
extern "C" int salun_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int batch, int nq, int nk, int d,
                                  float scale, void* stream) {
  if (!shape_ok(batch, nq, nk, d, MAX_D_BWD)) {
    return (int)cudaErrorInvalidValue;
  }
  SALUN_DISPATCH_NG(d, dq_ng, static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<float*>(dq),
                    batch, nq, nk, d, scale, stream)
}

// K3b: dk, dv [B, Nk, D] from the same inputs. The query walk is cut
// into ⌈nq / rows_per_split⌉ splits (rows_per_split a multiple of the
// tile's BQ); with more than one, `work` holds 2 · splits · B · Nk · D
// floats of partials.
extern "C" int salun_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, void* work, int batch,
                                   int nq, int nk, int d, int rows_per_split,
                                   float scale, void* stream) {
  if (!shape_ok(batch, nq, nk, d, MAX_D_BWD)) {
    return (int)cudaErrorInvalidValue;
  }
  return SALUN_DKV_CONFIG(
      d, dkv_launch, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(work), batch, nq, nk, d,
      rows_per_split, scale, stream);
}

// K3b's resident blocks per SM at head width d (for the split plan), or −1.
extern "C" int salun_flash_bwd_dkv_blocks_per_sm(int d) {
  if (d < 8 || d > MAX_D_BWD || d % 8) return -1;
  return SALUN_DKV_CONFIG(d, dkv_blocks_per_sm, d);
}
