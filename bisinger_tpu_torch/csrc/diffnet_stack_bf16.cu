// K1, bf16 route: the DiffNet residual stack, all L layers in one
// cooperative launch, on the tensor cores.
//
// Replaces bisinger_tpu/ops/diffnet_pallas.py:fused_residual_stack (body
// _stack_kernel) and rounds where it rounds. Per layer l with dilation
// d = dil[l], for every frame t:
//   a  = bf16(x + step[l])  zeroed outside [0, T)          (x, step bf16)
//   y  = sum_{tau in -1,0,1} a[t + tau*d] @ wd[l][tau+1]   (bf16 products, fp32 sum)
//        + bd[l] + cond[l][t]                              (fp32; cond read as bf16)
//   g  = bf16(sigmoid(y[:C]) * tanh(y[C:]))
//   z  = g @ wo[l] + bo[l]                                 (bf16 products, fp32 sum)
//   x  = bf16((x + z[:C]) * rsqrt(2));   skip += z[C:]     (skip fp32)
// Output: skip [B, T, C] fp32; the caller scales it by 1/sqrt(L).
//
// Design. As diffnet_stack.cu, the hidden state goes through device
// memory between layers (bf16 ping-pong buffers, L2-resident at the
// path's sizes) behind a grid barrier (cooperative launch), and blocks
// walk tiles of R frames of one sequence. Per tile, a block stages the
// window a (R + 2*dmax rows) in shared memory and computes both products
// as GEMMs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sum):
// the dilated taps read the window rows shifted by -d, 0, +d through
// ldmatrix, so a tap is only a row offset. The outputs run in passes of GP
// gate channels: a warp owns gate channels c.. AND the matching filter
// channels C+c.., so the gate is formed in registers and written, bf16,
// to an [R, C] buffer in shared memory, the A operand of the 1x1 GEMM,
// whose passes pair residual channel c with skip channel C+c the same way.
// The weights stream through a 3-stage cp.async ring in shared memory,
// each stage (64 or 128 input rows x the pass's columns) serving all R
// rows of the block. Every tile reads the whole layer's weights (1 MB) from
// L2 once per block, so the batch sets the shape:
//   - B=32, T=1024 (the bench): 128-frame tiles, one block each, 256 tiles;
//   - B=4, T=256 (the small batch, 1024 frames): 16-frame tiles split over
//     a cluster of two blocks, each owning half the channels (half the
//     weights) and sending its half of the gate to both blocks' buffers
//     through distributed shared memory before the 1x1 (a cluster barrier
//     each way), 128 blocks; where more tiles than clusters fit at once,
//     each cluster walks several.
// Global reads are batched: the window comes in by cp.async, and each
// epilogue loads its cond, x and skip values before it stores. mma.sync,
// not wgmma: a block owns 16 rows at the small batch, under wgmma's 64;
// wgmma for the 128-frame tiles is the next step. The other layout the
// design allows, one sequence's state held in a cluster's shared memory
// with no grid barrier, was not built (see PERF.md).
//
// Bound. 16*C^2 FLOP per frame per layer (3 taps C->2C, a 1x1 C->2C):
// 21.5 GFLOP per call at B=4, T=256, C=256, L=20 against ~42 MB of bf16
// inputs: the operations bound it (989 TFLOP/s bf16 dense on an H100
// SXM). At the small batch the per-stage barriers and the weight reads
// from L2 dominate instead; at the bench's batch, mma.sync's rate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace mma_bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 64;
constexpr float kRsqrt2 = 0.70710678118654752f;

struct Dilations {
  int d[kMaxLayers];
};

// R frames per tile; warp grid WM x WN; MT m16 tiles and, in each half
// (gate / filter, residual / skip), NG n8 tiles per warp; KC weight rows
// (input channels) per ring stage, NS ring stages; CL blocks per cluster.
// Chosen by timing variants on an H100 (K1 alone, C = 256, L = 20; the
// probe script was not kept): at B=32, T=1024, 64 rows a stage beat 32
// (half the barriers), while deeper rings (8 stages), 16 rows a stage and
// 64-row warp tiles (MT = 4, which spilled) were no faster; at B=4, T=256,
// 16-frame tiles over clusters of two beat whole tiles on one block and
// 32-frame tiles over clusters of four.
template <int R>
struct Cfg;
template <>
struct Cfg<16> {
  static constexpr int WM = 1, WN = 8, MT = 1, NG = 2, KC = 128, NS = 3, CL = 2;
};
template <>
struct Cfg<128> {
  static constexpr int WM = 4, WN = 2, MT = 2, NG = 4, KC = 64, NS = 3, CL = 1;
};

// CL blocks of a cluster share one tile of frames and split its channels:
// block r owns gate (and residual) channels [r*C/CL, (r+1)*C/CL)
template <int R>
struct Tile {
  static constexpr int WM = Cfg<R>::WM, WN = Cfg<R>::WN, MT = Cfg<R>::MT, NG = Cfg<R>::NG;
  static constexpr int KC = Cfg<R>::KC, NS = Cfg<R>::NS, CL = Cfg<R>::CL;
  static_assert(WM * WN * 32 == kThreads && 16 * MT * WM == R, "warp grid");
  static constexpr int GP = WN * NG * 8;  // gate channels per pass
  static_assert(NG % 2 == 0, "n8 tiles come in pairs");
  static constexpr int LDB = 2 * GP + 8;  // ring row stride (elements)
  static constexpr int TILE = KC * LDB;
};

// ring stage <- rows [kc, kc + KC) of tap q of W [taps][C][2C]: columns
// [col0, col0 + GP) and [C + col0, C + col0 + GP)
template <int R>
__device__ __forceinline__ void load_tile(bf16* slot, const bf16* __restrict__ W, int t, int C,
                                          int col0) {
  using P = Tile<R>;
  const int KT = C / P::KC;
  constexpr int CPH = P::GP / 8;  // 16-byte chunks per half row
  const bf16* src = W + ((size_t)(t / KT) * C + (size_t)(t % KT) * P::KC) * (2 * C) + col0;
  for (int c = threadIdx.x; c < P::KC * 2 * CPH; c += kThreads) {
    const int r = c / (2 * CPH), cc = c % (2 * CPH);
    const int half = cc / CPH, off = (cc % CPH) * 8;
    cp_async16(slot + r * P::LDB + half * P::GP + off,
               src + (size_t)r * (2 * C) + half * C + off);
  }
}

// acc[mt][0..NG) += rows of A x gate (or residual) columns, acc[mt][NG..2NG)
// += A x the matching filter (or skip) columns, over `taps` taps of
// W [taps][C][2C]; tap q reads A rows shifted by q * a_tap_step elements.
// (A ring kept filled across passes, tiles and layers instead of restarted
// here ran slower on an H100, as did a wgmma version of the 128-frame
// tiles with a wait at every stage.)
template <int R>
__device__ __forceinline__ void gemm(float (&acc)[Cfg<R>::MT][2 * Cfg<R>::NG][4],
                                     const bf16* a_base, int lda, int a_tap_step, int taps,
                                     const bf16* __restrict__ W, int C, int col0, bf16* ring) {
  using P = Tile<R>;
  constexpr int NG = P::NG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / P::WN, wn = warp % P::WN;
  const int KT = C / P::KC;
  const int ntiles = taps * KT;
  const bf16* arow[P::MT];
#pragma unroll
  for (int mt = 0; mt < P::MT; ++mt)
    arow[mt] = a_base + ((wm * P::MT + mt) * 16 + (lane & 15)) * lda + (lane >> 4) * 8;
  const int bcol = ((lane & 7) + ((lane >> 3) & 1) * 8) * P::LDB + wn * NG * 8 + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < P::NS - 1; ++s) {
    if (s < ntiles) load_tile<R>(ring + s * P::TILE, W, s, C, col0);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<P::NS - 2>();
    __syncthreads();  // tile i landed for every thread; tile i - 1's slot is free
    const int nx = i + P::NS - 1;
    if (nx < ntiles) load_tile<R>(ring + (nx % P::NS) * P::TILE, W, nx, C, col0);
    cp_async_commit();
    const int aoff = (i / KT) * a_tap_step + (i % KT) * P::KC;
    const bf16* tb = ring + (i % P::NS) * P::TILE + bcol;
#pragma unroll
    for (int ks = 0; ks < P::KC; ks += 16) {
      uint32_t a[P::MT][4];
#pragma unroll
      for (int mt = 0; mt < P::MT; ++mt) ldmatrix_a(a[mt], arow[mt] + aoff + ks);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int jp = 0; jp < NG; jp += 2) {
          uint32_t b[4];
          ldmatrix_b2(b, tb + ks * P::LDB + half * P::GP + jp * 8);
#pragma unroll
          for (int mt = 0; mt < P::MT; ++mt) {
            mma(acc[mt][half * NG + jp], a[mt], b[0], b[1]);
            mma(acc[mt][half * NG + jp + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
  }
  __syncthreads();  // the ring is refilled by the next GEMM
}

template <int CL>
__device__ __forceinline__ void sync_cluster() {
  if constexpr (CL > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) residual_stack_bf16_kernel(
    const bf16* x0, const bf16* __restrict__ cond, const bf16* __restrict__ step,
    const bf16* __restrict__ wd, const float* __restrict__ bd, const bf16* __restrict__ wo,
    const float* __restrict__ bo, bf16* xbuf, float* skip, int B, int T, int C, int L,
    int dmax, Dilations dil) {
  using P = Tile<R>;
  constexpr int NG = P::NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = C + 8;  // ldmatrix rows hit distinct banks
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [R + 2*dmax][lda]: a, masked
  bf16* sG = sA + (size_t)(R + 2 * dmax) * lda;   // [R][lda]: gate
  bf16* ring = sG + (size_t)R * lda;               // [NS][KC][LDB]: weights
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / P::WN, wn = warp % P::WN;
  const int C2 = 2 * C;
  const int tiles_per_seq = (T + R - 1) / R;
  const int n_tiles = B * tiles_per_seq;
  // the (CL, 1, 1) cluster of this block, and its share of the channels
  const int rank = (int)(blockIdx.x % P::CL), n_clusters = (int)(gridDim.x / P::CL);
  const int c_lo = rank * (C / P::CL), c_hi = c_lo + C / P::CL;
  const int cid = (int)(blockIdx.x / P::CL);
  const size_t btc = (size_t)B * T * C;

  for (int l = 0; l < L; ++l) {
    const int d = dil.d[l];
    // x is written during the launch: plain loads, never the read-only path
    const bf16* src = (l == 0) ? x0 : xbuf + (size_t)((l - 1) & 1) * btc;
    bf16* dst = xbuf + (size_t)(l & 1) * btc;
    const bf16* wdl = wd + (size_t)l * 3 * C * C2;
    const bf16* wol = wo + (size_t)l * C * C2;
    const bf16* condl = cond + (size_t)l * B * T * C2;
    const float* bdl = bd + (size_t)l * C2;
    const float* bol = bo + (size_t)l * C2;

    for (int tile = cid; tile < n_tiles; tile += n_clusters) {
      const int b = tile / tiles_per_seq;
      const int t0 = (tile % tiles_per_seq) * R;
      const bf16* stepl = step + ((size_t)l * B + b) * C;
      // window rows dmax - d + i hold frame t0 - d + i: x comes in by
      // cp.async, every row in flight at once, then step is added in place
      const int C8 = C / 8;
      for (int e = threadIdx.x; e < (R + 2 * d) * C8; e += kThreads) {
        const int i = e / C8, c = (e % C8) * 8;
        const int t = t0 - d + i;
        bf16* row = sA + (size_t)(dmax - d + i) * lda + c;
        if (t >= 0 && t < T) {
          cp_async16(row, src + ((size_t)b * T + t) * C + c);
        } else {
          *reinterpret_cast<uint4*>(row) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int e = threadIdx.x; e < (R + 2 * d) * C8; e += kThreads) {
        const int i = e / C8, c = (e % C8) * 8;
        const int t = t0 - d + i;
        if (t < 0 || t >= T) continue;
        uint4* row = reinterpret_cast<uint4*>(sA + (size_t)(dmax - d + i) * lda + c);
        uint4 xv = *row;
        const uint4 sv = *reinterpret_cast<const uint4*>(stepl + c);
        uint32_t* xp = reinterpret_cast<uint32_t*>(&xv);
        const uint32_t* sp = reinterpret_cast<const uint32_t*>(&sv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 a = unpack_bf16x2(xp[q]), s2 = unpack_bf16x2(sp[q]);
          xp[q] = pack_bf16x2(a.x + s2.x, a.y + s2.y);
        }
        *row = xv;
      }
      __syncthreads();

      for (int col0 = c_lo; col0 < c_hi; col0 += P::GP) {
        float acc[P::MT][2 * NG][4];
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt)
#pragma unroll
          for (int n = 0; n < 2 * NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
        gemm<R>(acc, sA + (size_t)(dmax - d) * lda, lda, d * lda, 3, wdl, C, col0, ring);
        const int cb = col0 + wn * NG * 8 + (lane & 3) * 2;  // this lane's first channel
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt) {
          // every cond value of the m16 tile first, then the gates
          uint32_t cg_[2][NG], cf_[2][NG];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + (wm * P::MT + mt) * 16 + (lane >> 2) + 8 * h;
            const bf16* cr = condl + ((size_t)b * T + (t < T ? t : 0)) * C2 + cb;
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              cg_[h][j] = *reinterpret_cast<const uint32_t*>(cr + j * 8);
              cf_[h][j] = *reinterpret_cast<const uint32_t*>(cr + C + j * 8);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (wm * P::MT + mt) * 16 + (lane >> 2) + 8 * h;
            const bool valid = t0 + r < T;
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              const int ch = cb + j * 8;
              float g0 = 0.f, g1 = 0.f;
              if (valid) {
                const float2 cg2 = unpack_bf16x2(cg_[h][j]), cf2 = unpack_bf16x2(cf_[h][j]);
                const float yg0 = acc[mt][j][2 * h] + bdl[ch] + cg2.x;
                const float yg1 = acc[mt][j][2 * h + 1] + bdl[ch + 1] + cg2.y;
                const float yf0 = acc[mt][NG + j][2 * h] + bdl[C + ch] + cf2.x;
                const float yf1 = acc[mt][NG + j][2 * h + 1] + bdl[C + ch + 1] + cf2.y;
                g0 = tanhf(yf0) / (1.f + expf(-yg0));
                g1 = tanhf(yf1) / (1.f + expf(-yg1));
              }
              const uint32_t gv = pack_bf16x2(g0, g1);
              if constexpr (P::CL > 1) {  // every block of the cluster gets the gate
#pragma unroll
                for (int q = 0; q < P::CL; ++q)
                  *reinterpret_cast<uint32_t*>(cg::this_cluster().map_shared_rank(sG, q) +
                                               (size_t)r * lda + ch) = gv;
              } else {
                *reinterpret_cast<uint32_t*>(sG + (size_t)r * lda + ch) = gv;
              }
            }
          }
        }
      }
      sync_cluster<P::CL>();  // the whole gate is in sG

      for (int col0 = c_lo; col0 < c_hi; col0 += P::GP) {
        float acc[P::MT][2 * NG][4];
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt)
#pragma unroll
          for (int n = 0; n < 2 * NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
        gemm<R>(acc, sG, lda, 0, 1, wol, C, col0, ring);
        const int cb = col0 + wn * NG * 8 + (lane & 3) * 2;  // this lane's first channel
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt) {
          // every x and skip value of the m16 tile first, then the stores
          uint32_t xm[2][NG];
          float2 sk[2][NG];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + (wm * P::MT + mt) * 16 + (lane >> 2) + 8 * h;
            const size_t idx = ((size_t)b * T + (t < T ? t : 0)) * C + cb;
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              xm[h][j] = l + 1 < L ? *reinterpret_cast<const uint32_t*>(src + idx + j * 8) : 0u;
              sk[h][j] = l > 0 ? *reinterpret_cast<const float2*>(skip + idx + j * 8)
                               : make_float2(0.f, 0.f);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + (wm * P::MT + mt) * 16 + (lane >> 2) + 8 * h;
            if (t >= T) continue;
            const size_t idx = ((size_t)b * T + t) * C + cb;
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              const int ch = cb + j * 8;
              const float zr0 = acc[mt][j][2 * h] + bol[ch];
              const float zr1 = acc[mt][j][2 * h + 1] + bol[ch + 1];
              const float zs0 = acc[mt][NG + j][2 * h] + bol[C + ch];
              const float zs1 = acc[mt][NG + j][2 * h + 1] + bol[C + ch + 1];
              if (l + 1 < L) {
                const float2 x2 = unpack_bf16x2(xm[h][j]);
                *reinterpret_cast<uint32_t*>(dst + idx + j * 8) =
                    pack_bf16x2((x2.x + zr0) * kRsqrt2, (x2.y + zr1) * kRsqrt2);
              }
              *reinterpret_cast<float2*>(skip + idx + j * 8) =
                  make_float2(sk[h][j].x + zs0, sk[h][j].y + zs1);
            }
          }
        }
      }
      sync_cluster<P::CL>();  // sA and sG (of every block of the cluster) are refilled
    }
    if (l + 1 < L) grid.sync();  // layer l+1 reads neighbours' frames of layer l
  }
}

template <int R>
cudaError_t launch(const bf16* x0, const bf16* cond, const bf16* step, const bf16* wd,
                   const float* bd, const bf16* wo, const float* bo, bf16* xbuf, float* skip,
                   int B, int T, int C, int L, int dmax, const Dilations& dil, int sms,
                   cudaStream_t stream) {
  constexpr int CL = Tile<R>::CL;
  const size_t smem =
      ((size_t)(2 * R + 2 * dmax) * (C + 8) + (size_t)Tile<R>::NS * Tile<R>::TILE) * sizeof(bf16);
  auto kern = residual_stack_bf16_kernel<R>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = B * ((T + R - 1) / R);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;  // every block resident: grid.sync() is safe
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = CL;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 2 : 1;
  int resident = 0;  // clusters (of one block when CL == 1) that fit on the card at once
  if (CL > 1) {
    cfg.gridDim = dim3(n_tiles * CL);
    err = cudaOccupancyMaxActiveClusters(&resident, kern, &cfg);
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    resident = per_sm * sms;
  }
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((n_tiles < resident ? n_tiles : resident) * CL);
  err = cudaLaunchKernelEx(&cfg, kern, x0, cond, step, wd, bd, wo, bo, xbuf, skip, B, T, C, L,
                           dmax, dil);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x0 [B,T,C] bf16 (C = 256, the flagship's width, which the tile shapes and
// shared-memory sizes above are set for), cond [L,B,T,2C] bf16, step
// [L,B,C] bf16, wd [L,3,C,2C] bf16, bd [L,2C] fp32, wo [L,C,2C] bf16, bo
// [L,2C] fp32, all contiguous on
// `device`; dilations is a host array of L ints; xbuf [2,B,T,C] bf16
// scratch; skip [B,T,C] fp32 output. Returns a cudaError_t (0 on success).
int diffnet_residual_stack_bf16(const void* x0, const void* cond, const void* step,
                                const void* wd, const float* bd, const void* wo, const float* bo,
                                const int* dilations, void* xbuf, float* skip, int B, int T,
                                int C, int L, int device, void* stream) {
  if (L < 1 || L > kMaxLayers || C != 256 || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  Dilations dil;
  int dmax = 0;
  for (int l = 0; l < L; ++l) {
    if (dilations[l] < 1) return (int)cudaErrorInvalidValue;
    dil.d[l] = dilations[l];
    dmax = dilations[l] > dmax ? dilations[l] : dmax;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const bf16 *x0b = static_cast<const bf16*>(x0), *cb = static_cast<const bf16*>(cond),
             *sb = static_cast<const bf16*>(step), *wdb = static_cast<const bf16*>(wd),
             *wob = static_cast<const bf16*>(wo);
  bf16* xb = static_cast<bf16*>(xbuf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128-frame tiles where they still give every SM one, else 16-frame tiles
  // over clusters of two
  const bool wide = (long long)B * ((T + 127) / 128) >= sms;
  err = wide ? launch<128>(x0b, cb, sb, wdb, bd, wob, bo, xb, skip, B, T, C, L, dmax, dil, sms, s)
             : launch<16>(x0b, cb, sb, wdb, bd, wob, bo, xb, skip, B, T, C, L, dmax, dil, sms, s);
  return (int)err;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
