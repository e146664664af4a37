// Fused masked-SGD update for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces salun/kernels/masked_update.py::_masked_sgd_kernel, the Pallas
// TPU kernel that applies SalUn's whole optimizer step to flat buffers:
//
//   keep  = mask > 0
//   buf'  = (momentum * buf + g * mask) + wd * p
//   p'    = p - lr * buf'
//   p, buf <- keep ? (p', buf') : (theta0, 0)
//
// The operands are summed in the order of the JAX main path
// (salun/core/masked_opt.py::masked_sgd_fused), not of the Pallas kernel,
// and every product and sum is an explicitly rounded intrinsic
// (__fmul_rn/__fadd_rn/__fsub_rn) that nvcc never contracts into an FMA.
// So the kernel is bitwise equal to its plain PyTorch version
// (salun_torch/kernels/masked_update.py::masked_sgd_update_reference).
//
// Bound: HBM bytes. Per element it reads p, buf, g, theta0 (fp32) and the
// mask (uint8) and writes p and buf: 25 bytes for ~6 flops, far below the
// H100's ~20 flop/byte ridge. The design therefore only moves bytes:
// one grid-stride pass that touches each byte once, 16-byte vector loads
// and stores (float4 / uchar4) when every pointer is aligned, streaming
// cache hints (the buffers are larger than L2 and never re-read within the
// step), and lr read from device memory so a schedule change costs no host
// sync and no rebuild.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void masked_sgd_one(float& p, float& b, float g,
                                               float m, float t0, float lr,
                                               float momentum, float wd) {
  const float b_new = __fadd_rn(__fadd_rn(__fmul_rn(momentum, b),
                                          __fmul_rn(g, m)),
                                __fmul_rn(wd, p));
  const float p_new = __fsub_rn(p, __fmul_rn(lr, b_new));
  const bool keep = m > 0.0f;
  p = keep ? p_new : t0;
  b = keep ? b_new : 0.0f;
}

__global__ void masked_sgd_kernel(float* __restrict__ p,
                                  float* __restrict__ buf,
                                  const float* __restrict__ g,
                                  const uint8_t* __restrict__ mask,
                                  const float* __restrict__ theta0,
                                  const float* __restrict__ lr_ptr,
                                  float momentum, float wd, int64_t n,
                                  int64_t n_vec) {
  const float lr = __ldg(lr_ptr);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;

  // Vector body: n_vec groups of 4 elements (0 when a pointer is not
  // 16-byte aligned; then the scalar loop below does everything).
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* b4 = reinterpret_cast<float4*>(buf);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* t4 = reinterpret_cast<const float4*>(theta0);
  const uchar4* m4 = reinterpret_cast<const uchar4*>(mask);
  for (int64_t i = tid; i < n_vec; i += stride) {
    float4 pv = __ldcs(p4 + i);
    float4 bv = __ldcs(b4 + i);
    const float4 gv = __ldcs(g4 + i);
    const float4 tv = __ldcs(t4 + i);
    const uchar4 mv = __ldcs(m4 + i);
    masked_sgd_one(pv.x, bv.x, gv.x, (float)mv.x, tv.x, lr, momentum, wd);
    masked_sgd_one(pv.y, bv.y, gv.y, (float)mv.y, tv.y, lr, momentum, wd);
    masked_sgd_one(pv.z, bv.z, gv.z, (float)mv.z, tv.z, lr, momentum, wd);
    masked_sgd_one(pv.w, bv.w, gv.w, (float)mv.w, tv.w, lr, momentum, wd);
    __stcs(p4 + i, pv);
    __stcs(b4 + i, bv);
  }

  // Scalar tail (and the whole range when unaligned).
  for (int64_t i = 4 * n_vec + tid; i < n; i += stride) {
    float pv = p[i];
    float bv = buf[i];
    masked_sgd_one(pv, bv, g[i], (float)mask[i], theta0[i], lr, momentum,
                   wd);
    p[i] = pv;
    buf[i] = bv;
  }
}

inline bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) % bytes) == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() so a refused launch surfaces.
extern "C" int salun_masked_sgd_update(void* p, void* buf, const void* g,
                                       const void* mask, const void* theta0,
                                       const void* lr, float momentum,
                                       float wd, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const bool vec = aligned(p, 16) && aligned(buf, 16) && aligned(g, 16) &&
                   aligned(theta0, 16) && aligned(mask, 4);
  const int64_t n_vec = vec ? n / 4 : 0;

  static int num_sms = 0;
  if (num_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, dev);
    if (num_sms <= 0) num_sms = 132;
  }
  const int threads = 256;
  const int64_t work = n_vec > 0 ? n_vec : n;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t max_blocks = (int64_t)num_sms * 8;  // grid-stride beyond
  if (blocks > max_blocks) blocks = max_blocks;
  masked_sgd_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(buf),
      static_cast<const float*>(g), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(theta0), static_cast<const float*>(lr),
      momentum, wd, n, n_vec);
  return (int)cudaGetLastError();
}
