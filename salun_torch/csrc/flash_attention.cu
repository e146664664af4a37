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
//       q-tiles (one block per k-tile, so dk/dv need no atomics).
// δ = Σ_d do∘o is computed outside the kernels, as in JAX.
//
// Layout: single head, q [B, Nq, D], k/v [B, Nk, D], fp32, contiguous,
// 16-byte aligned; any Nq, Nk ≥ 1 (the ragged last tile is masked), any
// D that is a multiple of 8, up to 512 for K2 and 256 for K3a/K3b, Nq ≠ Nk
// allowed.
//
// Bound: operations. At the DDPM training shape (B 128, N 256, D 256) K2
// does 4·B·N²·D = 8.6 GFLOP on 134 MB, K3a 6·B·N²·D and K3b 8·B·N²·D on
// about as many bytes: 64 to 128 flop per byte, above the H100's fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte). The kernels compute in
// plain fp32 FFMA (no TF32, no tensor cores), so that they agree with their
// plain PyTorch versions to fp32 rounding; their roof is the 67 TFLOP/s of
// the CUDA cores.
//
// Design against that bound: every product is a 32×32 tile read from
// shared memory, where each thread keeps a 2×4 (K2, K3a) or 1×4 (K3b)
// register tile of scores and 2 (or 1) rows × D/8 columns of the output
// accumulator, so each 16-byte shared-memory load feeds 4 to 8 FMAs. Rows
// are padded to D + 4 floats, which keeps the 16-byte loads of eight
// neighbouring rows free of bank conflicts for every D that is a multiple
// of 8. The softmax runs in registers, with the row reductions done by
// shuffles among the 8 threads that share a row. Tiles are 32 rows, so
// the DDPM mid block (N = 16) is one masked tile and D = 256 fits: K2
// uses 104 KB of shared memory (two blocks per SM), K3a and K3b about
// 140 KB (one block per SM), set with cudaFuncSetAttribute. Above D = 256
// (the SD VAE's mid-block attention, D = 512) K2 keeps one row per thread
// (R = 1, 256 threads): each thread's accumulator is then 1 × D/8 floats
// (64 at D = 512) instead of 2 × D/8, which would spill, and the three
// 32-row tiles of 516 floats plus the score tile take 202 KB of the
// 227 KB a block may use (one block per SM). TMA, wgmma and lower
// precisions are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int FWD_R = 2;

size_t fwd_smem(int d) {
  return sizeof(float) * (3 * TILE * row_stride(d) + TILE * SLD);
}

template <int R, int NG>
__global__ void __launch_bounds__(threads_for(R))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int nq, int nk, int d,
                 float scale) {
  constexpr int THREADS = threads_for(R);
  constexpr int G = TILE / R;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + TILE * row_stride(d);
  float* v_s = k_s + TILE * row_stride(d);
  float* p_s = v_s + TILE * row_stride(d);

  const int n_qt = (nq + TILE - 1) / TILE;
  const int b = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - b * n_qt) * TILE;
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  q += (int64_t)b * nq * d;
  o += (int64_t)b * nq * d;
  k += (int64_t)b * nk * d;
  v += (int64_t)b * nk * d;

  load_tile<THREADS>(q_s, q, q0, nq, d);
  float m[R], l[R];
  float4 acc[R][NG];
  zero(acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += TILE) {
    __syncthreads();  // the previous tile's k_s, v_s, p_s are read
    load_tile<THREADS>(k_s, k, k0, nk, d);
    load_tile<THREADS>(v_s, v, k0, nk, d);
    __syncthreads();
    float s[R][4];
    score_tile<R>(s, q_s, k_s, d, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = (k0 + tx + LANES * j < nk) ? s[r][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[r][j]);
      }
      // every k-tile holds a valid column, so m_new is finite; on the
      // first tile m = −inf and alpha = exp(−inf) = 0
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[r][j] - m_new);
        sum += p;
        p_s[(ty + r * G) * SLD + tx + LANES * j] = p;
      }
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[r][g].x *= alpha;
        acc[r][g].y *= alpha;
        acc[r][g].z *= alpha;
        acc[r][g].w *= alpha;
      }
    }
    __syncthreads();
    accum_tile<R, NG>(acc, p_s, v_s, d, ty, tx);
  }

  float inv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) inv[r] = 1.f / l[r];
  store_rows<R, NG>(o, acc, inv, q0, nq, d, ty, tx);
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = q0 + ty + r * G;
      if (row < nq) lse[(int64_t)b * nq + row] = m[r] + logf(l[r]);
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

constexpr int DKV_R = 1;  // two accumulators: one row per thread

size_t dkv_smem(int d) {
  return sizeof(float) * (4 * TILE * row_stride(d) + 2 * TILE * SLD +
                          2 * TILE);
}

template <int R, int NG>
__global__ void __launch_bounds__(threads_for(R))
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int nq,
                     int nk, int d, float scale) {
  constexpr int THREADS = threads_for(R);
  constexpr int G = TILE / R;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + TILE * row_stride(d);
  float* q_s = v_s + TILE * row_stride(d);
  float* do_s = q_s + TILE * row_stride(d);
  float* p_s = do_s + TILE * row_stride(d);
  float* ds_s = p_s + TILE * SLD;
  float* lse_s = ds_s + TILE * SLD;
  float* dl_s = lse_s + TILE;

  const int n_kt = (nk + TILE - 1) / TILE;
  const int b = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - b * n_kt) * TILE;
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;
  q += (int64_t)b * nq * d;
  dout += (int64_t)b * nq * d;
  lse += (int64_t)b * nq;
  delta += (int64_t)b * nq;
  k += (int64_t)b * nk * d;
  v += (int64_t)b * nk * d;
  dk += (int64_t)b * nk * d;
  dv += (int64_t)b * nk * d;

  load_tile<THREADS>(k_s, k, k0, nk, d);
  load_tile<THREADS>(v_s, v, k0, nk, d);
  float4 acc_k[R][NG], acc_v[R][NG];
  zero(acc_k);
  zero(acc_v);

  for (int q0 = 0; q0 < nq; q0 += TILE) {
    __syncthreads();
    load_tile<THREADS>(q_s, q, q0, nq, d);
    load_tile<THREADS>(do_s, dout, q0, nq, d);
    if (threadIdx.x < TILE) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < nq ? lse[row] : 0.f;
      dl_s[threadIdx.x] = row < nq ? delta[row] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are this block's keys, columns the queries
    float st[R][4], dpt[R][4];
    score_tile<R>(st, k_s, q_s, d, ty, tx);
    score_tile<R>(dpt, v_s, do_s, d, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + LANES * j;
        const float p =
            q0 + col < nq ? expf(st[r][j] * scale - lse_s[col]) : 0.f;
        p_s[(ty + r * G) * SLD + col] = p;
        ds_s[(ty + r * G) * SLD + col] = p * (dpt[r][j] - dl_s[col]);
      }
    }
    __syncthreads();
    accum_tile<R, NG>(acc_v, p_s, do_s, d, ty, tx);
    accum_tile<R, NG>(acc_k, ds_s, q_s, d, ty, tx);
  }

  float one[R], mul[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    one[r] = 1.f;
    mul[r] = scale;
  }
  store_rows<R, NG>(dk, acc_k, mul, k0, nk, d, ty, tx);
  store_rows<R, NG>(dv, acc_v, one, k0, nk, d, ty, tx);
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

// Two rows per thread up to D = 256, one above (see the note at the top).
template <int NG>
int fwd_ng(const float* q, const float* k, const float* v, float* o,
           float* lse, int batch, int nq, int nk, int d, float scale,
           void* stream) {
  constexpr int R = NG <= 8 ? FWD_R : 1;
  return launch(flash_fwd_kernel<R, NG>, threads_for(R), grid_for(batch, nq),
                fwd_smem(d), stream, q, k, v, o, lse, nq, nk, d, scale);
}

template <int NG>
int dq_ng(const float* q, const float* k, const float* v, const float* dout,
          const float* lse, const float* delta, float* dq, int batch, int nq,
          int nk, int d, float scale, void* stream) {
  return launch(flash_bwd_dq_kernel<DQ_R, NG>, threads_for(DQ_R),
                grid_for(batch, nq), dq_smem(d), stream, q, k, v, dout, lse,
                delta, dq, nq, nk, d, scale);
}

template <int NG>
int dkv_ng(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dk, float* dv,
           int batch, int nq, int nk, int d, float scale, void* stream) {
  return launch(flash_bwd_dkv_kernel<DKV_R, NG>, threads_for(DKV_R),
                grid_for(batch, nk), dkv_smem(d), stream, q, k, v, dout, lse,
                delta, dk, dv, nq, nk, d, scale);
}

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

// The same for K2 up to D = 512.
#define SALUN_DISPATCH_NG_FWD(d, FN, ...)    \
  switch (((d) + 31) / 32) {                 \
    case 9: return FN<9>(__VA_ARGS__);       \
    case 10: return FN<10>(__VA_ARGS__);     \
    case 11: return FN<11>(__VA_ARGS__);     \
    case 12: return FN<12>(__VA_ARGS__);     \
    case 13: return FN<13>(__VA_ARGS__);     \
    case 14: return FN<14>(__VA_ARGS__);     \
    case 15: return FN<15>(__VA_ARGS__);     \
    case 16: return FN<16>(__VA_ARGS__);     \
    default: SALUN_DISPATCH_NG(d, FN, __VA_ARGS__) \
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
  SALUN_DISPATCH_NG_FWD(d, fwd_ng, static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o),
                    static_cast<float*>(lse), batch, nq, nk, d, scale,
                    stream)
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

// K3b: dk, dv [B, Nk, D] from the same inputs.
extern "C" int salun_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int batch, int nq,
                                   int nk, int d, float scale, void* stream) {
  if (!shape_ok(batch, nq, nk, d, MAX_D_BWD)) {
    return (int)cudaErrorInvalidValue;
  }
  SALUN_DISPATCH_NG(d, dkv_ng, static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta), static_cast<float*>(dk),
                    static_cast<float*>(dv), batch, nq, nk, d, scale, stream)
}
