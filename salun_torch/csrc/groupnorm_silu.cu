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
// (batch, group) slab is n = gc·S contiguous values; channel c covers one
// contiguous plane of S values. Any B, C, S ≥ 1 and any G dividing C.
//
// Bound: bytes. Forward 8 B per value (x read, y written), backward 12 B
// (x, dy read, dx written) against 3.35 TB/s; a handful of flops per value
// is far below the fp32 ridge. The JAX row cap (_MAX_ROW_ELEMS, a VMEM
// limit) does not apply: groups of any size are reduced.
//
// Design: one launch, one thread-block cluster of k ≤ 16 blocks per slab
// (K4b adds a small launch). Block r of the cluster owns the slice
// [start[r], start[r + 1]) of its slab; the plan in
// kernels/groupnorm_silu.py picks k and how much of a slice stays in
// shared memory (`cap` values).
//   * Work is dealt to warps in units of ≤ 512 values: a unit lies in one
//     plane where S ≥ 512, or packs 512/S whole planes where S divides 512
//     (8×8 and 16×16 planes; slices then start on plane boundaries), so no
//     value needs an index division. w and b of the slab's channels sit in
//     shared memory.
//   * Each warp copies its units' resident part to shared memory with a
//     ring of 16-byte cp.async two units deep, and reduces a unit once it
//     has landed. Past `cap` (only where a slab does not fit: the VAE's
//     512×512 planes) values are read from HBM where they are used.
//   K4:  each unit's (count, mean, M2) is a two-pass over registers, merged
//        by Chan's formula (no E[x²] − μ², so a 2M-value group keeps its
//        precision): units in warp order, warps in order, then the blocks'
//        triples over distributed shared memory (DSMEM) in rank order. Every
//        block merges the same triples in the same order, so all hold the
//        same bits of mean and rstd; rank 0 writes them (the residuals the
//        backward reads). Then y from shared memory with 16-byte stores.
//        HBM traffic: resident x once, y once, 8 B per value (the bound);
//        streamed values 12 B.
//   K4b: (1) per unit Σ dz and Σ dz·x̂ per plane (a segmented butterfly
//        where a unit packs planes), dz left in shared memory over dy; the
//        plane sums go to a per-(slab, rank, plane) scratch and, w_c-
//        weighted, into the block's two sums; (2) the blocks' sums over
//        DSMEM in rank order give mean_g(dx̂) and mean_g(dx̂·x̂); (3) dx from
//        shared memory (no second σ where dz was kept). A second launch,
//        started early (programmatic dependent launch), sums the scratch
//        per channel over batch and ranks, one warp a channel, into dscale
//        and dbias. HBM traffic: x, dy once, dx once (12 B per value, the
//        bound) where resident; streamed values 20 B.
// σ uses the SFU's exp and reciprocal (__expf, __fdividef: a few ulp).
// The scalar path (S % 4 ≠ 0 or a pointer not 16-byte aligned) is the same
// kernel with cap = 0 and scalar loads: everything streamed.
// Every sum is taken in a fixed order (no atomics): the results are bitwise
// equal run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;
constexpr int UNIT = 512;                 // values of one warp's unit
constexpr int PER_LANE = UNIT / WARP;     // 16 values a lane
constexpr int MAX_CLUSTER = 16;           // non-portable above 8
constexpr int SMEM_DYN_MAX = 232448 - 1024;  // the rest: static arrays

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;  // the same bits in every lane (a butterfly of commuting adds)
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

// σ(z) with the SFU's exp and reciprocal (a few ulp; 0 and 1 in the limits).
__device__ __forceinline__ float sigmoid(float z) {
  return __fdividef(1.f, 1.f + __expf(-z));
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for all but the newest group of this thread's copies.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The two halves of cluster.sync(): after arrive, this block no longer
// reads the others' shared memory; wait, before exit, keeps its own alive
// until every block of the cluster has arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Geo {
  int64_t n;     // values of a slab, gc·S
  int64_t S;     // values of a plane
  int64_t cap;   // values of a slice kept in shared memory
  int64_t pmax;  // planes a slice can touch (K4b scratch stride)
  int64_t lmax;  // values of the largest slice
  int C, gc, groups, k;
  int shift;     // log2 S where a unit packs whole planes, else -1
  // slice r of every slab is [start[r], start[r + 1]); its first value
  // lies in plane p0[r] (computed on the host: no 64-bit division here)
  int64_t start[MAX_CLUSTER + 1];
  int64_t p0[MAX_CLUSTER + 1];
};

// The units of warp `warp` in slice r of a slab (offsets within the slab),
// in order, dealt to the warps round-robin. Where planes are large, each
// plane's part of the slice is cut into units of ≤ UNIT values (a unit
// lies in one plane); where S divides UNIT (g.shift ≥ 0; slices then start
// on plane boundaries), a unit is UNIT/S whole planes. Warp-uniform.
struct Units {
  int64_t hi, S, p, a, e, first, nu, u;
  int shift;

  __device__ Units(const Geo& g, int r, int warp)
      : hi(g.start[r + 1]), S(g.S), p(g.p0[r]), a(g.start[r]), first(0),
        u(warp), shift(g.shift) {
    e = min64(hi, (p + 1) * S);
    nu = (e - a + UNIT - 1) / UNIT;
  }

  // The next unit: its number un, (first) plane pl, first value o and
  // length; false past the last.
  __device__ bool next(int64_t& un, int64_t& pl, int64_t& o, int& len) {
    if (shift >= 0) {
      o = a + u * UNIT;
      if (o >= hi) return false;
      un = u;
      pl = o >> shift;
      len = (int)min64(UNIT, hi - o);
      u += WARPS;
      return true;
    }
    if (a >= hi) return false;  // an empty slice
    while (u >= first + nu) {
      if (e >= hi) return false;
      first += nu;
      a = e;
      ++p;
      e = min64(hi, (p + 1) * S);
      nu = (e - a + UNIT - 1) / UNIT;
    }
    un = u;
    pl = p;
    o = a + (u - first) * UNIT;
    len = (int)min64(UNIT, e - o);
    u += WARPS;
    return true;
  }
};

// Calls f(u, p, o, len) for each unit of the warp in slice r.
template <typename F>
__device__ __forceinline__ void for_units(const Geo& g, int r, int warp,
                                          F f) {
  Units it(g, r, warp);
  int64_t u, p, o;
  int len;
  while (it.next(u, p, o, len)) f(u, p, o, len);
}

// As for_units, with a ring of cp.async copies two units deep:
// issue(o, len) starts the copies of a unit's resident part to shared
// memory, and f runs on a unit once they have landed, while the next
// unit's copy is in flight.
template <typename I, typename F>
__device__ __forceinline__ void for_units_ahead(const Geo& g, int r,
                                                int warp, I issue, F f) {
  Units it(g, r, warp);
  int64_t u = 0, p = 0, o = 0;
  int len = 0;
  bool have = it.next(u, p, o, len);
  if (have) issue(o, len);
  cp_async_commit();
  while (have) {
    int64_t u1 = 0, p1 = 0, o1 = 0;
    int len1 = 0;
    const bool more = it.next(u1, p1, o1, len1);
    if (more) issue(o1, len1);
    cp_async_commit();
    cp_async_wait_one();  // this unit's group has landed
    __syncwarp();
    f(u, p, o, len);
    u = u1;
    p = p1;
    o = o1;
    len = len1;
    have = more;
  }
}

// Units slice r falls into (as Units numbers them).
__device__ __forceinline__ int64_t unit_count(const Geo& g, int r) {
  const int64_t lo = g.start[r], hi = g.start[r + 1];
  if (g.shift >= 0) return (hi - lo + UNIT - 1) / UNIT;
  int64_t nu = 0;
  int64_t p = g.p0[r];
  for (int64_t a = lo; a < hi; ++p) {
    const int64_t e = min64(hi, (p + 1) * g.S);
    nu += (e - a + UNIT - 1) / UNIT;
    a = e;
  }
  return nu;
}

// Offset within its unit of the value a lane holds in v[i]: on the vector
// path float4 number lane + 32·(i / 4) (row i / 4), else value lane + 32·i.
template <bool VEC>
__device__ __forceinline__ int at(int lane, int i) {
  return VEC ? 4 * (lane + WARP * (i / 4)) + i % 4 : lane + WARP * i;
}

// Plane (within the slab) of the lane's row q of the unit at o whose first
// plane is p (the vector path; a unit of one plane: p).
__device__ __forceinline__ int row_plane(const Geo& g, int64_t o, int64_t p,
                                         int lane, int q) {
  if (g.shift < 0) return (int)p;
  const int pl = (int)((o + 4 * (lane + WARP * q)) >> g.shift);
  return pl < g.gc ? pl : g.gc - 1;  // past the slab: a value not used
}

// The lane's values of the unit at slice offset `off` (len values): from
// shared memory `sm` below `res`, else from `g` (the slice in HBM); 0 past
// the unit's end.
template <bool VEC>
__device__ __forceinline__ void load_unit(float (&v)[PER_LANE],
                                          const float* sm,
                                          const float* __restrict__ g,
                                          int64_t off, int len, int64_t res,
                                          int lane) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      const int o = 4 * (lane + WARP * q);
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (o < len) {
        const int64_t s = off + o;
        t = s < res ? *reinterpret_cast<const float4*>(sm + s)
                    : *reinterpret_cast<const float4*>(g + s);
      }
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const int o = lane + WARP * q;
      float t = 0.f;
      if (o < len) {
        const int64_t s = off + o;
        t = s < res ? sm[s] : g[s];
      }
      v[q] = t;
    }
  }
}

// The lane's results r[i] to `g` (the slice in HBM) at slice offset `off`.
template <bool VEC>
__device__ __forceinline__ void store_unit(const float (&r)[PER_LANE],
                                           float* __restrict__ g, int64_t off,
                                           int len, int lane) {
  if (VEC) {
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      const int o = 4 * (lane + WARP * q);
      if (o < len) {
        *reinterpret_cast<float4*>(g + off + o) =
            make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const int o = lane + WARP * q;
      if (o < len) g[off + o] = r[q];
    }
  }
}

// Writes the lane's values r[i] of the unit at slice offset `off` that lie
// below `res` back to shared memory `sm` (vector path).
__device__ __forceinline__ void store_resident(const float (&r)[PER_LANE],
                                               float* sm, int64_t off,
                                               int len, int64_t res,
                                               int lane) {
#pragma unroll
  for (int q = 0; q < PER_LANE / 4; ++q) {
    const int o = 4 * (lane + WARP * q);
    if (o < len && off + o < res) {
      *reinterpret_cast<float4*>(sm + off + o) =
          make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    }
  }
}

// Starts the 16-byte cp.async copies of the lane's float4s of the unit at
// slice offset `off` (len values) that lie below `res`, from the slice `g`
// in HBM to `sm`. The lane copies the float4s load_unit reads.
__device__ __forceinline__ void copy_unit(float* sm, const float* g,
                                          int64_t off, int len, int64_t res,
                                          int lane) {
#pragma unroll
  for (int q = 0; q < PER_LANE / 4; ++q) {
    const int o = 4 * (lane + WARP * q);
    if (o < len && off + o < res) cp_async16(sm + off + o, g + off + o);
  }
}

// The slab's channel affines w, b to shared memory (gc values each).
__device__ __forceinline__ void load_affine(float* wsm, float* bsm,
                                            const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            int c0, int gc) {
  for (int i = threadIdx.x; i < gc; i += THREADS) {
    wsm[i] = w[c0 + i];
    bsm[i] = b[c0 + i];
  }
}

// ------------------------------------------------------------------ K4

// Dynamic shared memory: x (cap values), then w and b of the slab's gc
// channels.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
gn_fwd(const float* __restrict__ x, const float* __restrict__ w,
       const float* __restrict__ b, float* __restrict__ y,
       float* __restrict__ stats, Geo g, float eps) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* wsm = sm + g.cap;
  float* bsm = wsm + g.gc;
  __shared__ float red[WARPS][3];
  __shared__ float tri[3];
  __shared__ float st[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t slab = blockIdx.x / g.k;
  const int64_t lo = g.start[rank], hi = g.start[rank + 1];
  const int64_t res = min64(hi - lo, g.cap);
  const float* xs = x + slab * g.n + lo;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  load_affine(wsm, bsm, w, b, (int)(slab % g.groups) * g.gc, g.gc);

  float wn = 0.f, wm = 0.f, wm2 = 0.f;
  auto stats_of = [&](int64_t, int64_t, int64_t o, int len) {
    float v[PER_LANE];
    load_unit<VEC>(v, sm, xs, o - lo, len, res, lane);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) s += v[i];
    const float mu = warp_sum(s) / (float)len;
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const float d = v[i] - mu;
      if (at<VEC>(lane, i) < len) m2 = fmaf(d, d, m2);
    }
    merge(wn, wm, wm2, (float)len, mu, warp_sum(m2));
  };
  for_units_ahead(
      g, rank, warp,
      [&](int64_t o, int len) {
        if (VEC) copy_unit(sm, xs, o - lo, len, res, lane);
      },
      stats_of);
  if (lane == 0) {
    red[warp][0] = wn;
    red[warp][1] = wm;
    red[warp][2] = wm2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int i = 0; i < WARPS; ++i) merge(n, m, m2, red[i][0], red[i][1],
                                         red[i][2]);
    tri[0] = n;
    tri[1] = m;
    tri[2] = m2;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int r = 0; r < g.k; ++r) {
      const float* t = cluster.map_shared_rank(tri, r);
      merge(n, m, m2, t[0], t[1], t[2]);
    }
    st[0] = m;
    st[1] = 1.f / sqrtf(m2 / n + eps);
    if (rank == 0) {
      stats[slab] = st[0];
      stats[(int64_t)gridDim.x / g.k + slab] = st[1];
    }
  }
  cluster_arrive();
  __syncthreads();

  const float m = st[0], rs = st[1];
  float* ys = y + slab * g.n + lo;
  for_units(g, rank, warp, [&](int64_t, int64_t p, int64_t o, int len) {
    float v[PER_LANE];
    load_unit<VEC>(v, sm, xs, o - lo, len, res, lane);
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      const int pl = VEC ? row_plane(g, o, p, lane, q) : (int)p;
      const float wc = wsm[pl] * rs, bc = bsm[pl];
#pragma unroll
      for (int i = 4 * q; i < 4 * q + 4; ++i) {
        const float z = (v[i] - m) * wc + bc;
        v[i] = z * sigmoid(z);
      }
    }
    store_unit<VEC>(v, ys, o - lo, len, lane);
  });
  cluster_wait();
}

// ------------------------------------------------------------------ K4b

// dz and x̂ of one value.
struct Grad {
  float dz, xh;
};

__device__ __forceinline__ Grad grad_of(float v, float gy, float m, float r,
                                        float w, float b) {
  const float xh = (v - m) * r;
  const float z = xh * w + b;
  const float s = sigmoid(z);
  return {gy * s * (1.f + z * (1.f - s)), xh};
}

// Σ over the aligned groups of `seg` lanes (a power of two ≤ 32): every
// lane of a group gets the same bits.
__device__ __forceinline__ float seg_sum(float v, int seg) {
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
    if (off < seg) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Dynamic shared memory: x, then dy (cap values each; pass 1 leaves dz
// where dy was), w and b of the slab's gc channels, then per entry (one
// unit of one plane, or one plane of a packed unit) two sums and its
// plane.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
gn_bwd(const float* __restrict__ dy, const float* __restrict__ x,
       const float* __restrict__ w, const float* __restrict__ b,
       const float* __restrict__ mean, const float* __restrict__ rstd,
       float* __restrict__ dx, float* __restrict__ part, Geo g) {
  extern __shared__ float4 smem4[];
  float* xsm = reinterpret_cast<float*>(smem4);
  float* gsm = xsm + g.cap;
  float* wsm = gsm + g.cap;
  float* bsm = wsm + g.gc;
  float* tab = bsm + g.gc;
  __shared__ float blk[2];
  __shared__ float st[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t slab = blockIdx.x / g.k;
  const int64_t lo = g.start[rank], hi = g.start[rank + 1];
  const int64_t res = min64(hi - lo, g.cap);
  // entries: one per unit, or one per plane where units pack planes
  const int64_t nent = g.shift >= 0 ? (hi - lo) >> g.shift
                                    : unit_count(g, rank);
  int* tabp = reinterpret_cast<int*>(tab + 2 * nent);
  const float* xs = x + slab * g.n + lo;
  const float* gs = dy + slab * g.n + lo;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int c0 = (int)(slab % g.groups) * g.gc;
  load_affine(wsm, bsm, w, b, c0, g.gc);
  const float m = mean[slab], r = rstd[slab];
  __syncthreads();

  auto sums_of = [&](int64_t u, int64_t p, int64_t o, int len) {
    float v[PER_LANE], d[PER_LANE];
    load_unit<VEC>(v, xsm, xs, o - lo, len, res, lane);
    load_unit<VEC>(d, gsm, gs, o - lo, len, res, lane);
    float r1[PER_LANE / 4], r2[PER_LANE / 4];  // per row
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      const int pl = VEC ? row_plane(g, o, p, lane, q) : (int)p;
      const float wc = wsm[pl], bc = bsm[pl];
      r1[q] = r2[q] = 0.f;  // dy = 0 past the unit's end: dz = 0
#pragma unroll
      for (int i = 4 * q; i < 4 * q + 4; ++i) {
        const Grad a = grad_of(v[i], d[i], m, r, wc, bc);
        r1[q] += a.dz;
        r2[q] = fmaf(a.dz, a.xh, r2[q]);
        d[i] = a.dz;
      }
    }
    if (VEC) store_resident(d, gsm, o - lo, len, res, lane);  // dz over dy
    if (g.shift < 0) {  // one plane: one entry
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < PER_LANE / 4; ++q) {
        s1 += r1[q];
        s2 += r2[q];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        tab[2 * u] = s1;
        tab[2 * u + 1] = s2;
        tabp[u] = (int)p;
      }
      return;
    }
    // packed: a plane is `seg` lanes of one row (S ≤ 128) or two whole
    // rows (S = 256) of S/4 float4s
    const int f4 = (int)(g.S / 4);
    const int seg = f4 < WARP ? f4 : WARP;
    const bool pairs = f4 > WARP;
    const int64_t first = u * (UNIT >> g.shift);  // entry of the unit
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      r1[q] = seg_sum(r1[q], seg);
      r2[q] = seg_sum(r2[q], seg);
    }
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      float a1 = r1[q], a2 = r2[q];
      int slot = q;
      if (pairs) {
        if (q % 2) continue;
        a1 += r1[q + 1];
        a2 += r2[q + 1];
        slot = q / 2;
      }
      const int64_t e = first + slot * (WARP / seg) + lane / seg;
      if (lane % seg == 0 && e < nent) {
        tab[2 * e] = a1;
        tab[2 * e + 1] = a2;
        tabp[e] = (int)(g.p0[rank] + e);
      }
    }
  };
  for_units_ahead(
      g, rank, warp,
      [&](int64_t o, int len) {
        if (VEC) {
          copy_unit(xsm, xs, o - lo, len, res, lane);
          copy_unit(gsm, gs, o - lo, len, res, lane);
        }
      },
      sums_of);
  // let gn_bwd_wb's blocks start; it waits for this grid's end to read
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    // per plane in entry order → scratch; w_c-weighted into block sums
    float* out = part + ((slab * g.k + rank) * g.pmax) * 2;
    const int64_t p0 = g.p0[rank];
    float t1 = 0.f, t2 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int64_t e = 0; e < nent; ++e) {
      a1 += tab[2 * e];
      a2 += tab[2 * e + 1];
      const int p = tabp[e];
      if (e + 1 == nent || tabp[e + 1] != p) {
        out[2 * (p - p0)] = a1;
        out[2 * (p - p0) + 1] = a2;
        t1 = fmaf(wsm[p], a1, t1);
        t2 = fmaf(wsm[p], a2, t2);
        a1 = a2 = 0.f;
      }
    }
    blk[0] = t1;
    blk[1] = t2;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < g.k; ++q) {
      const float* t = cluster.map_shared_rank(blk, q);
      s1 += t[0];
      s2 += t[1];
    }
    st[0] = s1 / (float)g.n;
    st[1] = s2 / (float)g.n;
  }
  cluster_arrive();
  __syncthreads();

  const float m1 = st[0], m2 = st[1];
  float* ds = dx + slab * g.n + lo;
  for_units(g, rank, warp, [&](int64_t, int64_t p, int64_t o, int len) {
    float v[PER_LANE], d[PER_LANE];
    load_unit<VEC>(v, xsm, xs, o - lo, len, res, lane);
    load_unit<VEC>(d, gsm, gs, o - lo, len, res, lane);
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      const int pl = VEC ? row_plane(g, o, p, lane, q) : (int)p;
      const float wc = wsm[pl], bc = bsm[pl];
#pragma unroll
      for (int i = 4 * q; i < 4 * q + 4; ++i) {
        Grad a;
        if (o - lo + at<VEC>(lane, i) < res) {  // dz kept by pass 1
          a = {d[i], (v[i] - m) * r};
        } else {
          a = grad_of(v[i], d[i], m, r, wc, bc);
        }
        v[i] = r * (a.dz * wc - m1 - a.xh * m2);
      }
    }
    store_unit<VEC>(v, ds, o - lo, len, lane);
  });
  cluster_wait();
}

// dscale and dbias of one channel a warp: lane j of the warp sums the
// scratch of the (batch, rank) pairs j, j + 32, … (batch-major, rank-minor)
// whose slice touches the channel's plane; then a butterfly over lanes.
__global__ void __launch_bounds__(THREADS)
gn_bwd_wb(const float* __restrict__ part, float* __restrict__ dw,
          float* __restrict__ db, int batch, Geo g) {
  // launched early (programmatic dependent launch): wait for gn_bwd
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int c = blockIdx.x * WARPS + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (c >= g.C) return;  // warp-uniform
  const int gi = c / g.gc;
  const int64_t p = c - gi * g.gc;
  float a1 = 0.f, a2 = 0.f;
  for (int j = lane; j < batch * g.k; j += WARP) {
    const int bi = j / g.k, q = j - bi * g.k;
    const int64_t lo = g.start[q], hi = g.start[q + 1];
    if (lo >= hi || hi <= p * g.S || lo >= (p + 1) * g.S) continue;
    const int64_t slab = (int64_t)bi * g.groups + gi;
    const float* t = part + ((slab * g.k + q) * g.pmax + (p - g.p0[q])) * 2;
    a1 += t[0];
    a2 += t[1];
  }
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (lane == 0) {
    db[c] = a1;
    dw[c] = a2;
  }
}

// ------------------------------------------------------------- launchers

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Checks the shape and the plan; fills g. Where S divides
// UNIT on the vector path, units pack whole planes and slices start on
// plane boundaries (then k ≤ gc); else slices are k near-equal parts,
// float4-aligned on the vector path.
bool geometry(Geo& g, int64_t batch, int C, int64_t S, int groups, int k,
              int64_t cap, bool vec) {
  if (batch < 1 || C < 1 || S < 1 || groups < 1 || C % groups != 0 ||
      k < 1 || k > MAX_CLUSTER || cap < 0 || cap % 4 != 0 ||
      (!vec && cap != 0) || (vec && S % 4 != 0)) {
    return false;
  }
  g.C = C;
  g.gc = C / groups;
  g.groups = groups;
  g.k = k;
  g.S = S;
  g.n = (int64_t)g.gc * S;
  g.cap = cap;
  g.shift = -1;
  if (vec && S < UNIT && UNIT % S == 0) {
    g.shift = 0;
    while (((int64_t)1 << g.shift) < S) ++g.shift;
    if (k > g.gc) return false;
  }
  int64_t& lmax = g.lmax;
  lmax = 0;
  for (int r = 0; r <= k; ++r) {
    g.start[r] = g.shift >= 0 ? (int64_t)r * g.gc / k * S
                 : vec        ? (int64_t)r * (g.n / 4) / k * 4
                              : (int64_t)r * g.n / k;
    g.p0[r] = g.start[r] / S;
    if (r > 0 && g.start[r] - g.start[r - 1] > lmax) {
      lmax = g.start[r] - g.start[r - 1];
    }
  }
  g.pmax = (lmax + S - 1) / S + 1;
  const int64_t blocks = batch * groups * k;
  return g.n < (int64_t)1 << 31 && blocks <= 0x7fffffff;
}

// Bytes of dynamic shared memory, `per` = 1 (K4) or 2 (K4b) resident
// values per value of a slice: the resident values (x; x and dy for
// K4b), w and b of a slab's channels, and for K4b 12 bytes per entry of a
// slice (at most ⌈largest slice / UNIT⌉ + pmax). The plan in
// kernels/groupnorm_silu.py computes the same.
int64_t smem_bytes(const Geo& g, int per) {
  const int64_t table =
      per == 2 ? 12 * ((g.lmax + UNIT - 1) / UNIT + g.pmax) : 0;
  return 4 * (per * g.cap + 2 * (int64_t)g.gc) + table;
}

// Raises a kernel's dynamic shared memory limit to SMEM_DYN_MAX and allows
// clusters above 8 blocks, once per kernel.
template <typename Kern>
cudaError_t prepare(Kern kern, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN_MAX);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  done = e == cudaSuccess;
  return e;
}

template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, int64_t blocks, int k, int64_t smem,
                           cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

bool fwd_ready[2], bwd_ready[2];

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream`, does
// not synchronise, and returns the launch's error (or cudaErrorInvalidValue
// for a shape or plan the kernels do not take). The plan
// (kernels/groupnorm_silu.py::_plan): `k` blocks a slab in one cluster,
// `cap` values of each slice resident in shared memory (a multiple of 4;
// 0 on the scalar path), `vec` the float4 path (S % 4 == 0 and 16-byte
// aligned tensors, checked here).

// K4: y = silu(groupnorm(x)·w + b); stats [2, batch, groups] receives mean
// then rstd.
extern "C" int salun_gn_silu_fwd(const void* x, const void* w, const void* b,
                                 void* y, void* stats, long long batch, int C,
                                 long long S, int groups, int k,
                                 long long cap, int vec, float eps,
                                 void* stream) {
  Geo g;
  if (!geometry(g, batch, C, S, groups, k, cap, vec != 0) ||
      (vec && !(aligned16(x) && aligned16(y)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t smem = smem_bytes(g, 1);
  if (smem > SMEM_DYN_MAX) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = batch * groups * k;
  cudaError_t e;
  if (vec) {
    e = prepare(gn_fwd<true>, fwd_ready[1]);
    if (e == cudaSuccess) {
      e = launch_cluster(gn_fwd<true>, blocks, k, smem, s, xf, wf, bf, yf,
                         sf, g, eps);
    }
  } else {
    e = prepare(gn_fwd<false>, fwd_ready[0]);
    if (e == cudaSuccess) {
      e = launch_cluster(gn_fwd<false>, blocks, k, smem, s, xf, wf, bf, yf,
                         sf, g, eps);
    }
  }
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

// K4b: dx [batch, C, S] and dwb = [dscale (C), dbias (C)] from dy, x, w, b
// and the forward's mean and rstd [batch, groups]; part is scratch of
// 2·batch·groups·k·pmax floats, pmax ≥ ⌈(largest slice) / S⌉ + 1.
extern "C" int salun_gn_silu_bwd(const void* dy, const void* x,
                                 const void* w, const void* b,
                                 const void* mean, const void* rstd, void* dx,
                                 void* dwb, void* part, long long batch,
                                 int C, long long S, int groups, int k,
                                 long long cap, long long pmax, int vec,
                                 void* stream) {
  Geo g;
  if (!geometry(g, batch, C, S, groups, k, cap, vec != 0) || pmax < g.pmax ||
      (vec && !(aligned16(x) && aligned16(dy) && aligned16(dx)))) {
    return (int)cudaErrorInvalidValue;
  }
  g.pmax = pmax;
  const int64_t smem = smem_bytes(g, 2);
  if (smem > SMEM_DYN_MAX) return (int)cudaErrorInvalidValue;
  const float* gf = static_cast<const float*>(dy);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  float* dxf = static_cast<float*>(dx);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = batch * groups * k;
  cudaError_t e;
  if (vec) {
    e = prepare(gn_bwd<true>, bwd_ready[1]);
    if (e == cudaSuccess) {
      e = launch_cluster(gn_bwd<true>, blocks, k, smem, s, gf, xf, wf, bf,
                         mf, rf, dxf, pf, g);
    }
  } else {
    e = prepare(gn_bwd<false>, bwd_ready[0]);
    if (e == cudaSuccess) {
      e = launch_cluster(gn_bwd<false>, blocks, k, smem, s, gf, xf, wf, bf,
                         mf, rf, dxf, pf, g);
    }
  }
  if (e != cudaSuccess) return (int)e;
  float* dwf = static_cast<float*>(dwb);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((C + WARPS - 1) / WARPS));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_bwd_wb, static_cast<const float*>(pf),
                         dwf, dwf + C, (int)batch, g);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

// How many clusters of k blocks of K4 (backward = 0) or K4b (1) with `smem`
// bytes of dynamic shared memory the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int salun_gn_silu_clusters(int k, long long smem, int backward,
                                      int vec) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)k);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  cudaError_t e;
  if (backward) {
    e = vec ? prepare(gn_bwd<true>, bwd_ready[1])
            : prepare(gn_bwd<false>, bwd_ready[0]);
    if (e == cudaSuccess) {
      e = vec ? cudaOccupancyMaxActiveClusters(&n, gn_bwd<true>, &cfg)
              : cudaOccupancyMaxActiveClusters(&n, gn_bwd<false>, &cfg);
    }
  } else {
    e = vec ? prepare(gn_fwd<true>, fwd_ready[1])
            : prepare(gn_fwd<false>, fwd_ready[0]);
    if (e == cudaSuccess) {
      e = vec ? cudaOccupancyMaxActiveClusters(&n, gn_fwd<true>, &cfg)
              : cudaOccupancyMaxActiveClusters(&n, gn_fwd<false>, &cfg);
    }
  }
  return e == cudaSuccess ? n : -1;
}
