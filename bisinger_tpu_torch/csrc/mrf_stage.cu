// K2: one HiFi-GAN MRF stage in one launch.
//
// Replaces bisinger_tpu/ops/mrf_pallas.py:fused_mrf_stage (bodies
// _mrf_kernel_static and _mrf_kernel_roll, which compute the same
// function; plan from plan_stage / stage_halo / stack_stage_weights).
// out = mean over blocks j of ResBlock1_j(x), where ResBlock1 with kernel k
// runs, for each dilation d:  x <- x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))
// (slope 0.1, biases included, SAME zero padding after every conv).
// x and out are [B, U, F] fp32, and so is every value in between; the
// weights are one flat fp32 buffer of the convs in order (block j,
// dilation i, conv1 then conv2), each laid out [k][F_in][F_out] as the
// flax kernel; biases [n_convs, F].
//
// Design (overlap-save, as the TPU kernel). A block of 256 threads owns
// one sequence b and Uc central samples. It loads a window of
// L = Uc + 2H samples (H = the largest block's receptive field per side)
// into shared memory and runs the whole ResBlock chain there: conv1 writes
// a second window buffer, conv2 adds into the first in place. The valid
// region shrinks by each conv's reach; positions outside [0, U) are reset
// to zero after every conv, which is the SAME padding. Every ResBlock
// restarts from the input window; its central samples are summed into
// `out`, which only this block writes. Both windows are fp32 and take
// 2*L*F values; at F = 256 one SM's 227 KB would not hold even the
// 2H = 120 halo samples, so there a cluster of CL = 2 blocks shares one
// time chunk: each block holds F/CL channels of both windows and computes
// those output channels, reading the other channels from its peer's
// shared memory (distributed shared memory), with a cluster barrier
// between convs. (At F = 128 one block with shorter chunks ran faster on
// an H100 than a cluster of two, and at F = 256 clusters of four ran no
// faster than two at the bench's batch.) Products accumulate in fp32
// registers: a warp computes 8 rows of the output, lane i owning channels
// i, i+32, ... of the block's share; window values are broadcast reads of
// shared memory, weights stream from L2 via the read-only cache.
//
// Bound. 252*F^2 FLOP per sample (sum of k = 21 over three blocks, six
// convs each) against 8 bytes per sample plus the weights: the operations
// bound it (fp32 CUDA cores, 67 TFLOP/s on an H100 SXM). The halo is
// recomputed (2H/Uc extra: 1.1x at F = 256 and 128, 0.36x at F = 64,
// 0.15x at F = 32), and the weights are re-read per 8-row tile; a wgmma
// version with the weights in shared memory is the next step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // output rows per warp and pass
constexpr int kMaxBlocks = 4;
constexpr int kMaxDils = 4;
constexpr float kSlope = 0.1f;

struct Plan {
  int n_blocks, n_dils;
  int k[kMaxBlocks];
  int dil[kMaxBlocks][kMaxDils];
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : kSlope * v; }

// every block of the cluster has finished its reads and writes of both windows
template <int CL>
__device__ __forceinline__ void sync_windows() {
  if constexpr (CL > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// the window `w` of cluster rank `r` (this block's own when CL == 1)
template <int CL>
__device__ __forceinline__ float* peer(float* w, int r) {
  if constexpr (CL > 1) {
    return cg::this_cluster().map_shared_rank(w, r);
  } else {
    return w;
  }
}

// Rows i in [lo, hi) of dst (this block's F/CL channels, from channel
// oc0 on) get  bias + sum_q sum_f lrelu(src[i + (q-half)*d][f]) * w[q][f][o]
// (added to dst when `residual`), zeroed where the sample lies outside
// [0, U). src is read across the cluster: channel f lives in rank f/(F/CL).
template <int F, int CL>
__device__ void conv_rows(float* src, float* dst, const float* __restrict__ w,
                          const float* __restrict__ bias, int k, int d, int lo, int hi,
                          bool residual, int pos0, int U, int oc0) {
  constexpr int FC = F / CL;
  constexpr int CT = FC / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = (k - 1) / 2;
  for (int base = lo + warp * kRows; base < hi; base += kWarps * kRows) {
    float acc[kRows][CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float bj = bias[oc0 + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][j] = bj;
    }
    int row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) row[r] = min(base + r, hi - 1);  // tail rows repeat
    for (int q = 0; q < k; ++q) {
      const int shift = (q - half) * d;
      for (int rr = 0; rr < CL; ++rr) {
        const float* s = peer<CL>(src, rr);
        const float* wq = w + (size_t)q * F * F + (size_t)rr * FC * F + oc0;
#pragma unroll 2
        for (int f = 0; f < FC; f += 4) {
          float wv[4][CT];
#pragma unroll
          for (int ff = 0; ff < 4; ++ff)
#pragma unroll
            for (int j = 0; j < CT; ++j)
              wv[ff][j] = __ldg(wq + (size_t)(f + ff) * F + lane + 32 * j);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 a =
                *reinterpret_cast<const float4*>(s + (size_t)(row[r] + shift) * FC + f);
            const float a0 = lrelu(a.x), a1 = lrelu(a.y), a2 = lrelu(a.z), a3 = lrelu(a.w);
#pragma unroll
            for (int j = 0; j < CT; ++j) {
              acc[r][j] = fmaf(a0, wv[0][j], acc[r][j]);
              acc[r][j] = fmaf(a1, wv[1][j], acc[r][j]);
              acc[r][j] = fmaf(a2, wv[2][j], acc[r][j]);
              acc[r][j] = fmaf(a3, wv[3][j], acc[r][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = base + r;
      if (i < hi) {
        const int p = pos0 + i;
        const bool inside = p >= 0 && p < U;
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          float* o = dst + (size_t)i * FC + lane + 32 * j;
          const float v = residual ? *o + acc[r][j] : acc[r][j];
          *o = inside ? v : 0.f;
        }
      }
    }
  }
}

template <int F, int CL>
__global__ void __launch_bounds__(kThreads, 1) mrf_stage_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* out, int U, int Uc, int H, Plan plan) {
  constexpr int FC = F / CL;
  extern __shared__ __align__(16) float smem[];
  const int L = Uc + 2 * H;
  float* sx = smem;
  float* st = smem + (size_t)L * FC;
  const int oc0 = (int)(blockIdx.x % CL) * FC;  // cluster rank * FC: the (CL,1,1) cluster
  const int b = blockIdx.y;
  const int u0 = (int)(blockIdx.x / CL) * Uc;
  const int pos0 = u0 - H;  // sample of window row 0
  const float* xb = x + (size_t)b * U * F + oc0;
  float* ob = out + (size_t)b * U * F + oc0;
  size_t woff = 0;
  int slot = 0;
  for (int j = 0; j < plan.n_blocks; ++j) {
    const int k = plan.k[j];
    for (int e = threadIdx.x; e < L * FC; e += kThreads) {
      const int p = pos0 + e / FC;
      sx[e] = (p >= 0 && p < U) ? xb[(size_t)p * F + e % FC] : 0.f;
    }
    sync_windows<CL>();
    int lo = 0, hi = L;  // rows still exact
    for (int i = 0; i < plan.n_dils; ++i) {
      const int d = plan.dil[j][i];
      const int r1 = d * (k - 1) / 2, r2 = (k - 1) / 2;
      lo += r1;
      hi -= r1;
      conv_rows<F, CL>(sx, st, w + woff, bias + (size_t)slot * F, k, d, lo, hi, false, pos0, U,
                       oc0);
      woff += (size_t)k * F * F;
      ++slot;
      sync_windows<CL>();
      lo += r2;
      hi -= r2;
      conv_rows<F, CL>(st, sx, w + woff, bias + (size_t)slot * F, k, 1, lo, hi, true, pos0, U,
                       oc0);
      woff += (size_t)k * F * F;
      ++slot;
      sync_windows<CL>();
    }
    const bool last = j + 1 == plan.n_blocks;
    for (int e = threadIdx.x; e < Uc * FC; e += kThreads) {
      const int u = u0 + e / FC;
      if (u < U) {
        const size_t o = (size_t)u * F + e % FC;
        const float v = (j == 0 ? 0.f : ob[o]) + sx[(size_t)H * FC + e];
        ob[o] = last ? v / (float)plan.n_blocks : v;
      }
    }
    __syncthreads();  // the next block reloads this block's window
  }
}

template <int F, int CL>
cudaError_t launch(const float* x, const float* w, const float* bias, float* out, int B, int U,
                   int H, const Plan& plan, int smem_max, cudaStream_t stream) {
  const int per_sample = 2 * (F / CL) * (int)sizeof(float);
  int L = smem_max / per_sample;
  if (L <= 2 * H) return cudaErrorInvalidConfiguration;
  int Uc = L - 2 * H;
  if (Uc > U) Uc = U;
  L = Uc + 2 * H;
  const size_t smem = (size_t)L * per_sample;
  auto kern = mrf_stage_kernel<F, CL>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((U + Uc - 1) / Uc) * CL, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, x, w, bias, out, U, Uc, H, plan);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out [B,U,F] fp32 contiguous on `device`; w, bias as described above;
// ks [n_blocks] and dils [n_blocks * n_dils] are host arrays (odd kernels).
// Returns a cudaError_t (0 on success).
int mrf_stage(const float* x, const float* w, const float* bias, float* out, int B, int U,
              int F, int n_blocks, int n_dils, const int* ks, const int* dils, int device,
              void* stream) {
  if (B < 1 || U < 1 || n_blocks < 1 || n_blocks > kMaxBlocks || n_dils < 1 ||
      n_dils > kMaxDils)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.n_blocks = n_blocks;
  plan.n_dils = n_dils;
  int H = 0;
  for (int j = 0; j < n_blocks; ++j) {
    if (ks[j] < 1 || ks[j] % 2 == 0) return (int)cudaErrorInvalidValue;
    plan.k[j] = ks[j];
    int reach = 0;
    for (int i = 0; i < n_dils; ++i) {
      plan.dil[j][i] = dils[j * n_dils + i];
      if (plan.dil[j][i] < 1) return (int)cudaErrorInvalidValue;
      reach += plan.dil[j][i] * (ks[j] - 1) / 2 + (ks[j] - 1) / 2;
    }
    H = reach > H ? reach : H;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 32: err = launch<32, 1>(x, w, bias, out, B, U, H, plan, smem_max, s); break;
    case 64: err = launch<64, 1>(x, w, bias, out, B, U, H, plan, smem_max, s); break;
    case 128: err = launch<128, 1>(x, w, bias, out, B, U, H, plan, smem_max, s); break;
    case 256: err = launch<256, 2>(x, w, bias, out, B, U, H, plan, smem_max, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
