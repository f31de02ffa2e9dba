// K2, bf16 route: one HiFi-GAN MRF stage in one launch, on the tensor cores.
//
// Replaces bisinger_tpu/ops/mrf_pallas.py:fused_mrf_stage with
// compute_dtype=bfloat16 (body _mrf_kernel_static). Same function as
// mrf_stage.cu: out = mean over blocks j of ResBlock1_j(x), where for each
// dilation d:  x <- x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x)))), SAME zero
// padding, slope 0.1. Rounding points are the TPU kernel's:
//   - the input window and the running block state are bf16 (`state`);
//   - lrelu runs on the bf16 state: max(v, 0) + bf16(0.1) * min(v, 0),
//     rounded to bf16 (the slope constant is bf16(0.1) = 0.10009765625);
//   - each conv is a product of bf16 operands with an fp32 sum, plus the
//     fp32 bias; conv1's output is rounded to bf16 (`tbuf`), conv2's is
//     added to the state in fp32 and the sum rounded to bf16;
//   - the cross-block sum and the mean are fp32.
// x and out are [B, U, F] fp32; weights one flat bf16 buffer of the convs
// in order (block j, dilation i, conv1 then conv2), each [k][F_in][F_out];
// biases [n_convs, F] fp32.
//
// Design (overlap-save, as mrf_stage.cu). A block owns one sequence b and
// Uc central samples, with a window of L = Uc + 2H rows (H = the widest
// block's receptive field per side) in shared memory: the state `sx` and
// conv1's output `st`, both bf16. Block j of the stage starts from the
// rows its own reach needs (H - reach_j trimmed off each side) and the
// exact region shrinks by each conv's reach.
// Each conv is an implicit GEMM [rows x k*F] by [k*F x F] on the tensor
// cores, bf16 in, fp32 sum. The A operand is read with ldmatrix straight
// from the window rows shifted by the tap's offset (a dilation is only a
// row offset; ldmatrix takes a row address per lane, where a wgmma
// shared-memory descriptor would need the rows 8-aligned) and lrelu is
// applied in registers. The weights stream through a 3-stage cp.async
// ring in shared memory, one tile of KC input channels x F output
// channels per stage, each tile serving all rows of the block's current
// row tile. Three warpgroups of 128 threads, each owning one (F = 256)
// or two m64 row tiles over all F columns, issue wgmma.mma_async m64nFk16
// with A from registers and B through a descriptor of the ring tile
// (stored as MN-major core matrices); the sums start from the bias. 192
// rows a row tile at F = 256 cover every conv's rows (at most 186), so a
// block reads each conv's weights from L2 once. One wait per stage.
// Timed on an H100 (PERF.md): this beat the first design, mma.sync
// m16n8k16 over eight warps with 64-row tiles at F = 256, at every width;
// two warpgroups, products kept in flight across the next stage's barrier
// (a fourth ring stage, two A register sets) and 32-row stages at
// F = 256 ran slower. A ring of bulk copies behind full/empty mbarriers,
// refilled by thread 0 with no block barrier, ran faster but
// deadlocked within 50 to 200 back-to-back launches in each of three runs
// (warpgroups waiting on a full barrier whose copy was never issued;
// cause not found), so the ring keeps cp.async and a block barrier per
// stage.
//
// Bound. 252*F^2 FLOP per sample (three blocks, k = 3 + 7 + 11, six convs
// each) against 8 bytes per sample plus the weights: the operations bound
// it (bf16 tensor cores, 989 TFLOP/s dense on an H100 SXM). Costs above
// that: the halo recompute, (Uc + 2H)/Uc for the widest block (Uc is set
// by shared memory, 76 at F = 256, and by filling the SMs below), a
// barrier and a wait per 8 KB weight stage, and the weights read from L2
// once per row tile.

#include <cuda_runtime.h>

#include "mma_bf16.cuh"

using bf16 = __nv_bfloat16;
using namespace mma_bf16;

namespace {

constexpr int kMaxBlocks = 4;
constexpr int kMaxDils = 4;
constexpr float kSlope = 0.10009765625f;  // bf16(0.1)

struct Plan {
  int n_blocks, n_dils;
  int k[kMaxBlocks];
  int dil[kMaxBlocks][kMaxDils];
  int reach[kMaxBlocks];
};

__device__ __forceinline__ uint32_t lrelu2(uint32_t v) {
  float2 f = unpack_bf16x2(v);
  if (f.x >= 0.f && f.y >= 0.f) return v;
  return pack_bf16x2(f.x >= 0.f ? f.x : kSlope * f.x, f.y >= 0.f ? f.y : kSlope * f.y);
}

// three warpgroups own MT m64 row tiles each (BM rows together) over all
// F output columns, 128 fp32 sums a thread
template <int F>
struct Cfg {
  static constexpr int NWG = 3;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int MT = F >= 256 ? 1 : 2;
  static constexpr int BM = 64 * MT * NWG;
  static constexpr int LDS = F + 8;  // window row stride: ldmatrix rows hit distinct banks
  static constexpr int KC = F >= 128 ? 16 : 32;
  static constexpr int NS = 3;  // ring stages, loads NS - 1 tiles ahead
  static constexpr int TILE = KC * F;  // core-matrix layout, no padding
};

// ring stage <- rows [kc, kc + KC) of tap q of one conv's [k][F][F] weights,
// as the core matrices of an MN-major wgmma B operand: core (K group g,
// N group n) at element (n * KC / 8 + g) * 64, its K-row r % 8 at 8 more
template <int F>
__device__ __forceinline__ void load_tile(bf16* slot, const bf16* __restrict__ w, int t) {
  using G = Cfg<F>;
  constexpr int KT = F / G::KC;
  const bf16* src = w + ((size_t)(t / KT) * F + (t % KT) * G::KC) * F;
  for (int c = threadIdx.x; c < G::KC * (F / 8); c += G::THREADS) {
    const int r = c % G::KC, n = c / G::KC;  // neighbouring threads fill neighbouring rows
    cp_async16(slot + (n * (G::KC / 8) + r / 8) * 64 + (r % 8) * 8, src + (size_t)r * F + n * 8);
  }
}

// Rows [lo, hi) of dst get  bias + sum_q lrelu(src[row + (q - half) * d]) @ w[q]
// (added to dst in fp32 when `residual`), rounded to bf16, zeroed where the
// sample lies outside [0, U).
template <int F>
__device__ void conv(const bf16* src, bf16* dst, const bf16* __restrict__ w,
                     const float* __restrict__ bias, int k, int d, int lo, int hi,
                     bool residual, int pos0, int U, bf16* ring) {
  using G = Cfg<F>;
  constexpr int KT = F / G::KC;
  constexpr int NA = F / 2;  // accumulators per thread per m64 tile
  constexpr uint32_t kLbo = 128, kSbo = G::KC * 16;  // core-matrix steps along K and N, bytes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int half = (k - 1) / 2;
  const int ntiles = k * KT;
  for (int m0 = lo; m0 < hi; m0 += G::BM) {
    const int r0 = m0 + wg * G::MT * 64;  // this warpgroup's first row
    const bool active = r0 < hi;          // the same for the whole warpgroup
    float acc[G::MT][NA];  // the sums start from the bias
#pragma unroll
    for (int nt = 0; nt < F / 8; ++nt) {
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + nt * 8 + (lane & 3) * 2));
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        acc[mt][4 * nt] = acc[mt][4 * nt + 2] = bv.x;
        acc[mt][4 * nt + 1] = acc[mt][4 * nt + 3] = bv.y;
      }
    }
    const bf16* arow[G::MT];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const int r = min(r0 + mt * 64 + wq * 16 + (lane & 15), hi - 1);  // tail rows repeat
      arow[mt] = src + r * G::LDS + (lane >> 4) * 8;
    }
#pragma unroll
    for (int s = 0; s < G::NS - 1; ++s) {
      if (s < ntiles) load_tile<F>(ring + s * G::TILE, w, s);
      cp_async_commit();
    }
    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait<G::NS - 2>();
      fence_proxy_async();
      __syncthreads();  // tile i landed for every thread; tile i - 1's products are done
      const int nx = i + G::NS - 1;
      if (nx < ntiles) load_tile<F>(ring + (nx % G::NS) * G::TILE, w, nx);
      cp_async_commit();
      if (!active) continue;
      const bf16* tb = ring + (i % G::NS) * G::TILE;
      const int aoff = ((i / KT) - half) * d * G::LDS + (i % KT) * G::KC;
      uint32_t a[G::KC / 16][G::MT][4];
#pragma unroll
      for (int ks = 0; ks < G::KC / 16; ++ks)
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          ldmatrix_a(a[ks][mt], arow[mt] + aoff + ks * 16);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[ks][mt][e] = lrelu2(a[ks][mt][e]);
        }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < G::KC / 16; ++ks) {
        const uint64_t desc = smem_desc(tb + ks * 128, kLbo, kSbo);  // K groups 2ks, 2ks + 1
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) wgmma_rs<F>(acc[mt], a[ks][mt], desc, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int e = 0; e < NA; ++e) reg_fence(acc[mt][e]);
    __syncthreads();  // the ring is refilled by the next row tile
    if (!active) continue;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + mt * 64 + wq * 16 + (lane >> 2) + 8 * h;
        if (r >= hi) continue;
        const int p = pos0 + r;
        const bool inside = p >= 0 && p < U;
#pragma unroll
        for (int nt = 0; nt < F / 8; ++nt) {
          const int col = nt * 8 + (lane & 3) * 2;
          float y0 = acc[mt][4 * nt + 2 * h];
          float y1 = acc[mt][4 * nt + 2 * h + 1];
          uint32_t* o = reinterpret_cast<uint32_t*>(dst + r * G::LDS + col);
          if (residual) {
            const float2 old = unpack_bf16x2(*o);
            y0 = old.x + y0;
            y1 = old.y + y1;
          }
          *o = pack_bf16x2(inside ? y0 : 0.f, inside ? y1 : 0.f);
        }
      }
    }
  }
}

template <int F>
__global__ void __launch_bounds__(Cfg<F>::THREADS, 1) mrf_stage_bf16_kernel(
    const float* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
    float* out, int U, int Uc, int H, Plan plan) {
  using G = Cfg<F>;
  constexpr int NTH = Cfg<F>::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = Uc + 2 * H;
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);
  bf16* st = sx + (size_t)L * G::LDS;
  bf16* ring = st + (size_t)L * G::LDS;
  const int b = blockIdx.y;
  const int u0 = blockIdx.x * Uc;
  const int pos0 = u0 - H;  // sample of window row 0
  const float* xb = x + (size_t)b * U * F;
  float* ob = out + (size_t)b * U * F;
  constexpr int Q = F / 4;  // float4 chunks per row
  size_t woff = 0;
  int slot = 0;
  for (int j = 0; j < plan.n_blocks; ++j) {
    const int k = plan.k[j];
    int lo = H - plan.reach[j], hi = L - (H - plan.reach[j]);  // rows still exact
    // four float4 loads in flight per thread, then their bf16 stores
    for (int e0 = threadIdx.x; e0 < (hi - lo) * Q; e0 += 4 * NTH) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NTH;
        const int p = pos0 + lo + e / Q;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < (hi - lo) * Q && p >= 0 && p < U)
          v[u] = *reinterpret_cast<const float4*>(xb + (size_t)p * F + (e % Q) * 4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NTH;
        if (e < (hi - lo) * Q)
          *reinterpret_cast<uint2*>(sx + (lo + e / Q) * G::LDS + (e % Q) * 4) =
              make_uint2(pack_bf16x2(v[u].x, v[u].y), pack_bf16x2(v[u].z, v[u].w));
      }
    }
    __syncthreads();
    for (int i = 0; i < plan.n_dils; ++i) {
      const int d = plan.dil[j][i];
      const int r1 = d * (k - 1) / 2, r2 = (k - 1) / 2;
      lo += r1;
      hi -= r1;
      conv<F>(sx, st, w + woff, bias + (size_t)slot * F, k, d, lo, hi, false, pos0, U, ring);
      woff += (size_t)k * F * F;
      ++slot;
      __syncthreads();
      lo += r2;
      hi -= r2;
      conv<F>(st, sx, w + woff, bias + (size_t)slot * F, k, 1, lo, hi, true, pos0, U, ring);
      woff += (size_t)k * F * F;
      ++slot;
      __syncthreads();
    }
    const bool last = j + 1 == plan.n_blocks;
    for (int e0 = threadIdx.x; e0 < Uc * Q; e0 += 4 * NTH) {
      float4 prev[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NTH;
        prev[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j > 0 && e < Uc * Q && u0 + e / Q < U)
          prev[u] = *reinterpret_cast<const float4*>(ob + (size_t)(u0 + e / Q) * F + (e % Q) * 4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NTH;
        if (e >= Uc * Q || u0 + e / Q >= U) continue;
        const uint2 sv =
            *reinterpret_cast<const uint2*>(sx + (size_t)(H + e / Q) * G::LDS + (e % Q) * 4);
        const float2 s01 = unpack_bf16x2(sv.x), s23 = unpack_bf16x2(sv.y);
        float4 v = make_float4(prev[u].x + s01.x, prev[u].y + s01.y, prev[u].z + s23.x,
                               prev[u].w + s23.y);
        if (last) {
          const float n = (float)plan.n_blocks;
          v = make_float4(v.x / n, v.y / n, v.z / n, v.w / n);
        }
        *reinterpret_cast<float4*>(ob + (size_t)(u0 + e / Q) * F + (e % Q) * 4) = v;
      }
    }
    __syncthreads();  // the next block reloads the window
  }
}

template <int F>
cudaError_t launch(const float* x, const bf16* w, const float* bias, float* out, int B, int U,
                   int H, const Plan& plan, int smem_max, int sms, cudaStream_t stream) {
  const size_t ring = (size_t)Cfg<F>::NS * Cfg<F>::TILE * sizeof(bf16);
  const size_t per_row = (size_t)2 * Cfg<F>::LDS * sizeof(bf16);
  int Uc = (int)(((long long)smem_max - (long long)ring) / (long long)per_row) - 2 * H;
  if (Uc < 16) return cudaErrorInvalidConfiguration;
  // short chunks where the longest would leave SMs idle
  const int min_chunks = (sms + B - 1) / B;
  const int fill = ((U + min_chunks - 1) / min_chunks + 15) / 16 * 16;
  if (fill < Uc) Uc = fill;
  if (Uc > U) Uc = U;
  const size_t smem = ring + (size_t)(Uc + 2 * H) * per_row;
  auto kern = mrf_stage_bf16_kernel<F>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((U + Uc - 1) / Uc, B), Cfg<F>::THREADS, smem, stream>>>(x, w, bias, out, U, Uc, H,
                                                                      plan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out [B,U,F] fp32 contiguous on `device`; w bf16 and bias fp32 as
// described above; ks [n_blocks] and dils [n_blocks * n_dils] are host
// arrays (odd kernels). Returns a cudaError_t (0 on success).
int mrf_stage_bf16(const float* x, const void* w, const float* bias, float* out, int B, int U,
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
    plan.reach[j] = reach;
    H = reach > H ? reach : H;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem_max = 0, sms = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const bf16* wb = static_cast<const bf16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 32: err = launch<32>(x, wb, bias, out, B, U, H, plan, smem_max, sms, s); break;
    case 64: err = launch<64>(x, wb, bias, out, B, U, H, plan, smem_max, sms, s); break;
    case 128: err = launch<128>(x, wb, bias, out, B, U, H, plan, smem_max, sms, s); break;
    case 256: err = launch<256>(x, wb, bias, out, B, U, H, plan, smem_max, sms, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
