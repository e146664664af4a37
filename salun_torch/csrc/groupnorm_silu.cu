// Fused GroupNorm + SiLU for Hopper (sm_90a): kernels K4 (forward) and K4b
// (backward) of the port.
//
// Replaces salun/kernels/groupnorm_silu.py:
//   K4  _gn_silu_kernel (via groupnorm_silu): y = silu((x − μ_g)·rstd_g·w_c
//       + b_c) with fp32 statistics per (batch, group), rstd = 1/√(σ² + eps);
//   K4b _gn_silu_bwd (the custom VJP, plain XLA in JAX): with x̂ = (x − μ)·
//       rstd, z = x̂·w + b, s = σ(z), dz = dy·s·(1 + z(1 − s)):
//       dbias_c = Σ dz, dscale_c = Σ dz·x̂ (over batch and space),
//       dx = rstd·(dx̂ − mean_g(dx̂) − x̂·mean_g(dx̂·x̂)) with dx̂ = dz·w.
//
// Layout: x [B, C, S] fp32 contiguous (NCHW with S = H·W), C = G·gc. A
// (batch, group) slab is gc·S contiguous values; channel c covers one
// contiguous plane of S values. Any B, C, S ≥ 1 and any G dividing C; the
// float4 path needs S % 4 == 0 and 16-byte aligned tensors, else scalar.
//
// Bound: bytes. Forward 8 B per value (x read, y written), backward 12 B
// (x, dy read, dx written) against 3.35 TB/s; a handful of flops per value
// is far below the fp32 ridge. The JAX row cap (_MAX_ROW_ELEMS, a VMEM
// limit) does not apply: groups of any size are reduced.
//
// Design: the work unit is one warp over one chunk of ≤ CHUNK values of one
// plane (a (batch, channel) pair), so channel and slab are uniform per warp
// and no value needs an index division. The largest group on the SD path
// (VAE decoder, 256 channels at 512×512, gc = 8: 2,097,152 values) falls
// into 8·64 units, and its batch of 4 gives 32,768 warps, though there are
// only 128 (batch, group) slabs: a split reduction.
//   K4:  (1) per unit, a two-pass (count, mean, M2) in fp32 (the chunk is
//        re-read from L1/L2); (2) one warp per slab merges its units'
//        partials by Chan's formula (no E[x²] − μ², so a 2M-value group
//        keeps its precision) into mean and rstd, which are also the
//        residuals the backward reads; (3) per unit, normalise, affine,
//        SiLU. HBM traffic: x twice, y once (12 B per value).
//   K4b: (1) per unit, Σ dz and Σ dz·x̂ from the saved mean/rstd;
//        (2) one warp per slab gives mean_g(dx̂), mean_g(dx̂·x̂) from
//        w_c-weighted partials, one warp per channel dscale and dbias;
//        (3) per unit, dx. HBM traffic: x and dy twice, dx once (20 B).
// Every sum is taken in a fixed order (no atomics): the results are
// deterministic, run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// (n, mean, m2) ← (n, mean, m2) ∪ (nb, mb, m2b), Chan et al.
__device__ __forceinline__ void merge(float& n, float& mean, float& m2,
                                      float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const float tot = n + nb;
  const float delta = mb - mean;
  const float f = nb / tot;
  mean = mean + delta * f;
  m2 = m2 + m2b + delta * delta * n * f;
  n = tot;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// The unit of the calling warp: which plane, where its chunk starts, and
// how long it is. Returns false for a warp past the last unit.
struct Unit {
  int64_t plane;  // b·C + c
  int64_t lo;     // first value of the chunk within the plane
  int64_t len;
};

__device__ __forceinline__ bool unit_of_warp(Unit& u, int64_t units,
                                             int64_t hw, int nch,
                                             int64_t chunk) {
  const int64_t unit = (int64_t)blockIdx.x * WARPS + threadIdx.x / WARP;
  if (unit >= units) return false;
  u.plane = unit / nch;
  u.lo = (unit - u.plane * nch) * chunk;
  const int64_t rest = hw - u.lo;
  u.len = rest < chunk ? rest : chunk;
  return true;
}

// f(value) for each value of the warp's chunk, returns nothing; the lanes
// stride over float4s (VEC) or single floats.
template <bool VEC, typename F>
__device__ __forceinline__ void for_chunk(const float* __restrict__ p,
                                          int64_t len, int lane, F f) {
  if (VEC) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (int64_t i = lane; i < len / 4; i += WARP) {
      const float4 v = p4[i];
      f(v.x);
      f(v.y);
      f(v.z);
      f(v.w);
    }
  } else {
    for (int64_t i = lane; i < len; i += WARP) f(p[i]);
  }
}

// ------------------------------------------------------------------ K4

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gn_stats_partial(const float* __restrict__ x, float* __restrict__ part,
                 int64_t units, int64_t hw, int nch, int64_t chunk) {
  Unit u;
  if (!unit_of_warp(u, units, hw, nch, chunk)) return;
  const int lane = threadIdx.x % WARP;
  const float* p = x + u.plane * hw + u.lo;
  float s = 0.f;
  for_chunk<VEC>(p, u.len, lane, [&](float v) { s += v; });
  const float mean = warp_sum(s) / (float)u.len;
  float m2 = 0.f;
  for_chunk<VEC>(p, u.len, lane, [&](float v) {
    const float d = v - mean;
    m2 = fmaf(d, d, m2);
  });
  m2 = warp_sum(m2);
  if (lane == 0) {
    const int64_t unit = u.plane * nch + u.lo / chunk;
    part[3 * unit] = (float)u.len;
    part[3 * unit + 1] = mean;
    part[3 * unit + 2] = m2;
  }
}

// One warp per (batch, group) slab: its gc·nch partials are contiguous.
__global__ void __launch_bounds__(THREADS)
gn_stats_finalize(const float* __restrict__ part, float* __restrict__ mean,
                  float* __restrict__ rstd, int64_t slabs, int64_t items,
                  float eps) {
  const int64_t slab = (int64_t)blockIdx.x * WARPS + threadIdx.x / WARP;
  if (slab >= slabs) return;
  const int lane = threadIdx.x % WARP;
  const float* p = part + 3 * slab * items;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  for (int64_t i = lane; i < items; i += WARP) {
    merge(n, mu, m2, p[3 * i], p[3 * i + 1], p[3 * i + 2]);
  }
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, mu, off);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, off);
    merge(n, mu, m2, nb, mb, m2b);
  }
  if (lane == 0) {
    mean[slab] = mu;
    rstd[slab] = 1.f / sqrtf(m2 / n + eps);
  }
}

__device__ __forceinline__ float gn_silu(float v, float m, float r, float w,
                                         float b) {
  const float z = (v - m) * r * w + b;
  return z * sigmoid(z);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gn_silu_apply(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, const float* __restrict__ mean,
              const float* __restrict__ rstd, float* __restrict__ y,
              int64_t units, int64_t hw, int nch, int64_t chunk, int C,
              int gc) {
  Unit u;
  if (!unit_of_warp(u, units, hw, nch, chunk)) return;
  const int lane = threadIdx.x % WARP;
  const int c = (int)(u.plane % C);
  const int64_t slab = u.plane / gc;
  const float m = mean[slab], r = rstd[slab], wc = w[c], bc = b[c];
  const int64_t off = u.plane * hw + u.lo;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x + off);
    float4* y4 = reinterpret_cast<float4*>(y + off);
    for (int64_t i = lane; i < u.len / 4; i += WARP) {
      const float4 v = x4[i];
      y4[i] = make_float4(gn_silu(v.x, m, r, wc, bc), gn_silu(v.y, m, r, wc, bc),
                          gn_silu(v.z, m, r, wc, bc), gn_silu(v.w, m, r, wc, bc));
    }
  } else {
    for (int64_t i = lane; i < u.len; i += WARP) {
      y[off + i] = gn_silu(x[off + i], m, r, wc, bc);
    }
  }
}

// ------------------------------------------------------------------ K4b

// dz and x̂ of one value.
struct Grad {
  float dz, xh;
};

__device__ __forceinline__ Grad grad_of(float v, float g, float m, float r,
                                        float w, float b) {
  const float xh = (v - m) * r;
  const float z = xh * w + b;
  const float s = sigmoid(z);
  return {g * s * (1.f + z * (1.f - s)), xh};
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gn_bwd_partial(const float* __restrict__ dy, const float* __restrict__ x,
               const float* __restrict__ w, const float* __restrict__ b,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               float* __restrict__ part, int64_t units, int64_t hw, int nch,
               int64_t chunk, int C, int gc) {
  Unit u;
  if (!unit_of_warp(u, units, hw, nch, chunk)) return;
  const int lane = threadIdx.x % WARP;
  const int c = (int)(u.plane % C);
  const int64_t slab = u.plane / gc;
  const float m = mean[slab], r = rstd[slab], wc = w[c], bc = b[c];
  const int64_t off = u.plane * hw + u.lo;
  float s1 = 0.f, s2 = 0.f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x + off);
    const float4* g4 = reinterpret_cast<const float4*>(dy + off);
    for (int64_t i = lane; i < u.len / 4; i += WARP) {
      const float4 v = x4[i], g = g4[i];
      const Grad a = grad_of(v.x, g.x, m, r, wc, bc);
      const Grad bb = grad_of(v.y, g.y, m, r, wc, bc);
      const Grad cc = grad_of(v.z, g.z, m, r, wc, bc);
      const Grad dd = grad_of(v.w, g.w, m, r, wc, bc);
      s1 += (a.dz + bb.dz) + (cc.dz + dd.dz);
      s2 += (a.dz * a.xh + bb.dz * bb.xh) + (cc.dz * cc.xh + dd.dz * dd.xh);
    }
  } else {
    for (int64_t i = lane; i < u.len; i += WARP) {
      const Grad a = grad_of(x[off + i], dy[off + i], m, r, wc, bc);
      s1 += a.dz;
      s2 += a.dz * a.xh;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const int64_t unit = u.plane * nch + u.lo / chunk;
    part[2 * unit] = s1;
    part[2 * unit + 1] = s2;
  }
}

// Warps [0, slabs): m1 = mean_g(dz·w), m2 = mean_g(dz·w·x̂) of one slab.
// Warps [slabs, slabs + C): dbias and dscale of one channel.
__global__ void __launch_bounds__(THREADS)
gn_bwd_finalize(const float* __restrict__ part, const float* __restrict__ w,
                float* __restrict__ m12, float* __restrict__ dw,
                float* __restrict__ db, int64_t slabs, int batch, int C,
                int gc, int nch, int64_t hw) {
  const int64_t idx = (int64_t)blockIdx.x * WARPS + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  float a = 0.f, bsum = 0.f;
  if (idx < slabs) {
    const int64_t items = (int64_t)gc * nch;
    const int64_t first_plane = idx * gc;
    for (int64_t i = lane; i < items; i += WARP) {
      const int64_t plane = first_plane + i / nch;
      const float wc = w[plane % C];
      const float* p = part + 2 * (first_plane * nch + i);
      a = fmaf(wc, p[0], a);
      bsum = fmaf(wc, p[1], bsum);
    }
    a = warp_sum(a);
    bsum = warp_sum(bsum);
    if (lane == 0) {
      const float n = (float)((int64_t)gc * hw);
      m12[2 * idx] = a / n;
      m12[2 * idx + 1] = bsum / n;
    }
  } else if (idx < slabs + C) {
    const int c = (int)(idx - slabs);
    const int64_t items = (int64_t)batch * nch;
    for (int64_t i = lane; i < items; i += WARP) {
      const int64_t bi = i / nch;
      const float* p = part + 2 * ((bi * C + c) * nch + (i - bi * nch));
      a += p[0];
      bsum += p[1];
    }
    a = warp_sum(a);
    bsum = warp_sum(bsum);
    if (lane == 0) {
      db[c] = a;
      dw[c] = bsum;
    }
  }
}

__device__ __forceinline__ float dx_of(float v, float g, float m, float r,
                                       float w, float b, float m1,
                                       float m2) {
  const Grad a = grad_of(v, g, m, r, w, b);
  return r * (a.dz * w - m1 - a.xh * m2);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gn_bwd_dx(const float* __restrict__ dy, const float* __restrict__ x,
          const float* __restrict__ w, const float* __restrict__ b,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float* __restrict__ m12, float* __restrict__ dx,
          int64_t units, int64_t hw, int nch, int64_t chunk, int C, int gc) {
  Unit u;
  if (!unit_of_warp(u, units, hw, nch, chunk)) return;
  const int lane = threadIdx.x % WARP;
  const int c = (int)(u.plane % C);
  const int64_t slab = u.plane / gc;
  const float m = mean[slab], r = rstd[slab], wc = w[c], bc = b[c];
  const float m1 = m12[2 * slab], m2 = m12[2 * slab + 1];
  const int64_t off = u.plane * hw + u.lo;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x + off);
    const float4* g4 = reinterpret_cast<const float4*>(dy + off);
    float4* d4 = reinterpret_cast<float4*>(dx + off);
    for (int64_t i = lane; i < u.len / 4; i += WARP) {
      const float4 v = x4[i], g = g4[i];
      d4[i] = make_float4(dx_of(v.x, g.x, m, r, wc, bc, m1, m2),
                          dx_of(v.y, g.y, m, r, wc, bc, m1, m2),
                          dx_of(v.z, g.z, m, r, wc, bc, m1, m2),
                          dx_of(v.w, g.w, m, r, wc, bc, m1, m2));
    }
  } else {
    for (int64_t i = lane; i < u.len; i += WARP) {
      dx[off + i] = dx_of(x[off + i], dy[off + i], m, r, wc, bc, m1, m2);
    }
  }
}

// ------------------------------------------------------------- launchers

struct Geometry {
  int64_t planes, units, slabs, hw, chunk;
  int C, gc, nch;
};

bool geometry(Geometry& g, int64_t batch, int C, int64_t hw, int groups,
              int64_t chunk) {
  if (batch < 1 || C < 1 || hw < 1 || groups < 1 || C % groups != 0 ||
      chunk < 1 || chunk > hw) {
    return false;
  }
  g.C = C;
  g.gc = C / groups;
  g.hw = hw;
  g.chunk = chunk;
  const int64_t nch = (hw + chunk - 1) / chunk;
  if (nch > 0x7fffffff) return false;
  g.nch = (int)nch;
  g.planes = batch * C;
  g.units = g.planes * nch;
  g.slabs = batch * groups;
  return (g.units + WARPS - 1) / WARPS <= 0x7fffffff &&
         (g.slabs + C + WARPS - 1) / WARPS <= 0x7fffffff;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + WARPS - 1) / WARPS);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (or cudaErrorInvalidValue
// for a shape the kernels do not take). `chunk` is the length of a warp's
// chunk of a plane (≤ hw; a multiple of 4 when hw > chunk); `part` is
// scratch of 3 (forward) or 2 (backward) floats per unit, units =
// batch·C·⌈hw / chunk⌉.

// K4: y = silu(groupnorm(x)·w + b); mean and rstd [batch, groups] written.
extern "C" int salun_gn_silu_fwd(const void* x, const void* w, const void* b,
                                 void* y, void* mean, void* rstd, void* part,
                                 long long batch, int C, long long hw,
                                 int groups, long long chunk, float eps,
                                 void* stream) {
  Geometry g;
  if (!geometry(g, batch, C, hw, groups, chunk)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = hw % 4 == 0 && chunk % 4 == 0 && aligned16(x) &&
                   aligned16(y);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(part);
  if (vec) {
    gn_stats_partial<true><<<blocks_for(g.units), THREADS, 0, s>>>(
        xf, pf, g.units, g.hw, g.nch, g.chunk);
  } else {
    gn_stats_partial<false><<<blocks_for(g.units), THREADS, 0, s>>>(
        xf, pf, g.units, g.hw, g.nch, g.chunk);
  }
  gn_stats_finalize<<<blocks_for(g.slabs), THREADS, 0, s>>>(
      pf, static_cast<float*>(mean), static_cast<float*>(rstd), g.slabs,
      (int64_t)g.gc * g.nch, eps);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  float* yf = static_cast<float*>(y);
  if (vec) {
    gn_silu_apply<true><<<blocks_for(g.units), THREADS, 0, s>>>(
        xf, wf, bf, mf, rf, yf, g.units, g.hw, g.nch, g.chunk, g.C, g.gc);
  } else {
    gn_silu_apply<false><<<blocks_for(g.units), THREADS, 0, s>>>(
        xf, wf, bf, mf, rf, yf, g.units, g.hw, g.nch, g.chunk, g.C, g.gc);
  }
  return (int)cudaGetLastError();
}

// K4b: dx [batch, C, hw], dw and db [C] from dy, x, w, b and the forward's
// mean and rstd; m12 is scratch of 2 floats per (batch, group) slab.
extern "C" int salun_gn_silu_bwd(const void* dy, const void* x,
                                 const void* w, const void* b,
                                 const void* mean, const void* rstd,
                                 void* dx, void* dw, void* db, void* part,
                                 void* m12, long long batch, int C,
                                 long long hw, int groups, long long chunk,
                                 void* stream) {
  Geometry g;
  if (!geometry(g, batch, C, hw, groups, chunk)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = hw % 4 == 0 && chunk % 4 == 0 && aligned16(x) &&
                   aligned16(dy) && aligned16(dx);
  const float* gf = static_cast<const float*>(dy);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  float* pf = static_cast<float*>(part);
  float* m12f = static_cast<float*>(m12);
  if (vec) {
    gn_bwd_partial<true><<<blocks_for(g.units), THREADS, 0, s>>>(
        gf, xf, wf, bf, mf, rf, pf, g.units, g.hw, g.nch, g.chunk, g.C,
        g.gc);
  } else {
    gn_bwd_partial<false><<<blocks_for(g.units), THREADS, 0, s>>>(
        gf, xf, wf, bf, mf, rf, pf, g.units, g.hw, g.nch, g.chunk, g.C,
        g.gc);
  }
  gn_bwd_finalize<<<blocks_for(g.slabs + g.C), THREADS, 0, s>>>(
      pf, wf, m12f, static_cast<float*>(dw), static_cast<float*>(db),
      g.slabs, (int)batch, g.C, g.gc, g.nch, g.hw);
  float* dxf = static_cast<float*>(dx);
  if (vec) {
    gn_bwd_dx<true><<<blocks_for(g.units), THREADS, 0, s>>>(
        gf, xf, wf, bf, mf, rf, m12f, dxf, g.units, g.hw, g.nch, g.chunk,
        g.C, g.gc);
  } else {
    gn_bwd_dx<false><<<blocks_for(g.units), THREADS, 0, s>>>(
        gf, xf, wf, bf, mf, rf, m12f, dxf, g.units, g.hw, g.nch, g.chunk,
        g.C, g.gc);
  }
  return (int)cudaGetLastError();
}
