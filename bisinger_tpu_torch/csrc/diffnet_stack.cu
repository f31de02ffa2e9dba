// K1, fp32 route: the DiffNet residual stack, all L layers in one
// cooperative launch, on the tensor cores in error-compensated TF32
// (3xTF32, `mma_tf32.cuh`).
//
// Replaces bisinger_tpu/ops/diffnet_pallas.py:fused_residual_stack (body
// _stack_kernel) with fp32 operands. Per layer l with dilation d = dil[l],
// for every frame t:
//   a      = (x + step[l])  zeroed outside [0, T)        (SAME padding)
//   y      = sum_{tau in -1,0,1} a[t + tau*d] @ wd[l][tau+1] + bd[l] + cond[l][t]
//   g      = sigmoid(y[:C]) * tanh(y[C:])
//   z      = g @ wo[l] + bo[l]
//   x      = (x + z[:C]) / sqrt(2);   skip += z[C:]
// all in fp32. Output: skip [B, T, C]; the caller scales it by 1/sqrt(L).
//
// Bound. 16*C^2 FLOP per frame per layer (3 taps C->2C, a 1x1 C->2C):
// 21.5 GFLOP per call at B=4, T=256, C=256, L=20 against ~85 MB of fp32
// inputs, so the operations bound it. fp32 accuracy costs three TF32
// products per product: the card's least time is the operations at 495 / 3
// = 165 TFLOP/s (TF32 tensor cores, dense, H100 SXM), against 67 TFLOP/s
// on the fp32 CUDA cores. Against the bf16 route (diffnet_stack_bf16.cu,
// the same structure on m16n8k16 bf16 products at 989 TFLOP/s) this route
// issues three m16n8k8 products, each at half the bf16 product's rate per
// FLOP, where that one issues one: six times the tensor-core time, plus
// the splits and twice the shared-memory bytes. Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py phase 6, PERF.md): 16.459 ms at B=32,
// T=1024 and 1.232 ms at B=4, T=256, 3.4x and 2.8x the bf16 route's 4.772
// and 0.442 ms.
//
// Design: diffnet_stack_bf16.cu's, in fp32. The hidden state goes through
// device memory between layers (fp32 ping-pong buffers, L2-resident at the
// path's sizes) behind a grid barrier (cooperative launch), and blocks walk
// tiles of R frames of one sequence. Per tile, a block stages the window a
// (R + 2*dmax rows, by cp.async) in shared memory and computes both
// products on mma.sync m16n8k8 TF32 in 3xTF32: the dilated taps read the
// window rows shifted by -d, 0, +d (64-bit loads, rows padded to C + 8
// floats so that a load's lanes hit distinct banks), each value split into
// hi and lo in registers, and the cross terms go in before hi * hi. The
// outputs run in passes of GP gate channels: a warp owns gate channels
// c.. AND the matching filter channels C+c.., so the gate is formed in
// registers and written, fp32, to an [R, C] buffer in shared memory, the A
// operand of the 1x1 GEMM, whose passes pair residual channel c with skip
// channel C+c the same way. The weights come through a two-slot ring in
// shared memory: each stage (KC input rows x the pass's 2*GP columns) is
// read into registers during the previous stage's products, split into hi
// and lo once per block and stored as 16-byte units, so a lane's four B
// registers of a k8 step are one 128-bit load, each stage serving all R
// rows of the block (a 3-stage cp.async ring of fp32 tiles, split in every
// warp's registers, ran slower on an H100). Tile
// sizes are half the bf16 route's, since every shared byte doubles:
//   - B=32, T=1024 (the bench): 64-frame tiles, one block each (window 80
//     rows, gate 64 rows, a 2 x 16-row ring: 213 KB), 512 tiles;
//   - B=4, T=256 (the small batch): 16-frame tiles split over a cluster
//     of two blocks, each owning half the channels (half the weights) and
//     sending its half of the gate to both blocks' buffers through
//     distributed shared memory before the 1x1 (a cluster barrier each
//     way), 128 blocks (16-row ring stages ran slower than 32).
// The products go straight into the sums: at K <= 768 a product they
// read 4.1e-6 to 4.6e-6 of the largest value, 75x or more under
// single-pass TF32, where the FFMA kernel it replaced read under 8.1e-7 (no
// run of this kernel with K2's partial sums is recorded). ptxas (-Xptxas -v,
// CUDA 12.8): 255 registers for both tile sizes; no spills at 64 frames,
// 124 bytes stored / 140 loaded at 16;
// no static shared memory (dynamic: 213 KB at 64 frames, 179 KB at 16,
// with dmax = 8).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"

namespace cg = cooperative_groups;
using namespace mma_tf32;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 64;
constexpr int kC = 256;  // the flagship's width: tile shapes and shared memory are set for it
constexpr float kRsqrt2 = 0.70710678118654752f;

struct Dilations {
  int d[kMaxLayers];
};

// R frames per tile; warp grid WM x WN; MT m16 tiles and, in each half
// (gate / filter, residual / skip), NG n8 tiles per warp; KC weight rows
// (input channels) per stage; CL blocks per cluster.
template <int R>
struct Cfg;
template <>
struct Cfg<16> {
  static constexpr int WM = 1, WN = 8, MT = 1, NG = 2, KC = 32, CL = 2;
};
template <>
struct Cfg<64> {
  static constexpr int WM = 2, WN = 4, MT = 2, NG = 4, KC = 16, CL = 1;
};

// CL blocks of a cluster share one tile of frames and split its channels:
// block r owns gate (and residual) channels [r*C/CL, (r+1)*C/CL)
template <int R>
struct Tile {
  static constexpr int WM = Cfg<R>::WM, WN = Cfg<R>::WN, MT = Cfg<R>::MT, NG = Cfg<R>::NG;
  static constexpr int KC = Cfg<R>::KC, CL = Cfg<R>::CL;
  static_assert(WM * WN * 32 == kThreads && 16 * MT * WM == R, "warp grid");
  static constexpr int GP = WN * NG * 8;  // gate channels per pass
  static_assert((kC / CL) % GP == 0, "passes");
  static constexpr int LDA = kC + 8;      // window and gate row stride (floats)
  // a stage's weights split into hi and lo: [KC / 2][LDB] units of 16 bytes
  // (LDB = 2 mod 8: a 128-bit B load's lanes hit distinct banks); PU units
  // staged per thread
  static constexpr int LDB = 2 * GP + 2;
  static constexpr int STAGE = KC / 2 * LDB * 4;  // 32-bit words
  static constexpr int PU = KC / 2 * 2 * GP / kThreads;
  static_assert(PU * kThreads == KC * GP, "staging");
};

// Stage t of W [taps][C][2C] is rows [kc, kc + KC) of tap q, columns
// [col0, col0 + GP) and [C + col0, C + col0 + GP) (stage columns [0, GP)
// and [GP, 2 GP)). load_b reads this thread's PU pairs of K rows (2p,
// 2p + 1) of one column into registers (neighbouring threads take
// neighbouring columns); store_b splits them and stores unit (p, n) =
// (hi(B[2p][n]), hi(B[2p+1][n]), lo(B[2p][n]), lo(B[2p+1][n])): each
// weight is split once per block, and a lane's four B registers of a k8
// step are one 128-bit load.
template <int R>
__device__ __forceinline__ void load_b(float (&v)[Tile<R>::PU][2], const float* __restrict__ W,
                                       int t, int col0) {
  using P = Tile<R>;
  constexpr int KT = kC / P::KC, N2 = 2 * P::GP;
  const float* src = W + ((size_t)(t / KT) * kC + (size_t)(t % KT) * P::KC) * (2 * kC) + col0;
#pragma unroll
  for (int u = 0; u < P::PU; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int p = e / N2, n = e % N2;
    const float* col = src + (n < P::GP ? n : kC + n - P::GP);
    v[u][0] = __ldg(col + (size_t)(2 * p) * (2 * kC));
    v[u][1] = __ldg(col + (size_t)(2 * p + 1) * (2 * kC));
  }
}

template <int R>
__device__ __forceinline__ void store_b(uint32_t* stage, const float (&v)[Tile<R>::PU][2]) {
  using P = Tile<R>;
  constexpr int N2 = 2 * P::GP;
#pragma unroll
  for (int u = 0; u < P::PU; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int p = e / N2, n = e % N2;
    uint32_t h0, l0, h1, l1;
    split(v[u][0], h0, l0);
    split(v[u][1], h1, l1);
    *reinterpret_cast<uint4*>(stage + (p * P::LDB + n) * 4) = make_uint4(h0, h1, l0, l1);
  }
}

// acc[mt][0..NG) += rows of A x gate (or residual) columns, acc[mt][NG..2NG)
// += A x the matching filter (or skip) columns, over `taps` taps of
// W [taps][C][2C]; tap q reads A rows shifted by q * a_tap_step floats.
// The weights go through a two-stage ring of split tiles: stage i + 1 is
// read into registers while stage i's products run.
template <int R>
__device__ __forceinline__ void gemm(float (&acc)[Cfg<R>::MT][2 * Cfg<R>::NG][4],
                                     const float* a_base, int a_tap_step, int taps,
                                     const float* __restrict__ W, int col0, uint32_t* ring) {
  using P = Tile<R>;
  constexpr int NG = P::NG, KT = kC / P::KC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / P::WN, wn = warp % P::WN;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = taps * KT;
  int arow[P::MT][2];  // rows g and g + 8 of each m16 tile, column 2t
#pragma unroll
  for (int mt = 0; mt < P::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) arow[mt][h] = ((wm * P::MT + mt) * 16 + g + 8 * h) * P::LDA + 2 * t;
  float bv[P::PU][2];
  load_b<R>(bv, W, 0, col0);
  for (int i = 0; i < ntiles; ++i) {
    uint32_t* stage = ring + (i & 1) * P::STAGE;
    store_b<R>(stage, bv);
    __syncthreads();  // stage i is in; every thread is done with stage i - 2, its slot
    if (i + 1 < ntiles) load_b<R>(bv, W, i + 1, col0);
    const float* a = a_base + (i / KT) * a_tap_step + (i % KT) * P::KC;
    const uint32_t* tb = stage + (t * P::LDB + wn * NG * 8 + g) * 4;
#pragma unroll
    for (int ks = 0; ks < P::KC / 8; ++ks) {
      uint32_t ah[P::MT][4], al[P::MT][4];
#pragma unroll
      for (int mt = 0; mt < P::MT; ++mt)
        split_a(*reinterpret_cast<const float2*>(a + arow[mt][0] + ks * 8),
                *reinterpret_cast<const float2*>(a + arow[mt][1] + ks * 8), ah[mt], al[mt]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const uint4 b = *reinterpret_cast<const uint4*>(
              tb + (ks * 4 * P::LDB + half * P::GP + j * 8) * 4);
#pragma unroll
          for (int mt = 0; mt < P::MT; ++mt)
            mma3(acc[mt][half * NG + j], ah[mt], al[mt], b.x, b.y, b.z, b.w);
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
__global__ void __launch_bounds__(kThreads, 1) residual_stack_kernel(
    const float* x0, const float* __restrict__ cond, const float* __restrict__ step,
    const float* __restrict__ wd, const float* __restrict__ bd, const float* __restrict__ wo,
    const float* __restrict__ bo, float* xbuf, float* skip, int B, int T, int L, int dmax,
    Dilations dil) {
  using P = Tile<R>;
  constexpr int NG = P::NG, C = kC, C2 = 2 * kC, LDA = P::LDA;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                            // [R + 2*dmax][LDA]: a, masked
  float* sG = sA + (size_t)(R + 2 * dmax) * LDA;  // [R][LDA]: gate
  uint32_t* ring = reinterpret_cast<uint32_t*>(sG + (size_t)R * LDA);  // [2][STAGE]: weights
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / P::WN, wn = warp % P::WN;
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
    const float* src = (l == 0) ? x0 : xbuf + (size_t)((l - 1) & 1) * btc;
    float* dst = xbuf + (size_t)(l & 1) * btc;
    const float* wdl = wd + (size_t)l * 3 * C * C2;
    const float* wol = wo + (size_t)l * C * C2;
    const float* condl = cond + (size_t)l * B * T * C2;
    const float* bdl = bd + (size_t)l * C2;
    const float* bol = bo + (size_t)l * C2;

    for (int tile = cid; tile < n_tiles; tile += n_clusters) {
      const int b = tile / tiles_per_seq;
      const int t0 = (tile % tiles_per_seq) * R;
      const float* stepl = step + ((size_t)l * B + b) * C;
      // window rows dmax - d + i hold frame t0 - d + i: x comes in by
      // cp.async, every row in flight at once, then step is added in place
      constexpr int C4 = C / 4;
      for (int e = threadIdx.x; e < (R + 2 * d) * C4; e += kThreads) {
        const int i = e / C4, c = (e % C4) * 4;
        const int t = t0 - d + i;
        float* row = sA + (size_t)(dmax - d + i) * LDA + c;
        if (t >= 0 && t < T) {
          cp_async16(row, src + ((size_t)b * T + t) * C + c);
        } else {
          *reinterpret_cast<float4*>(row) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int e = threadIdx.x; e < (R + 2 * d) * C4; e += kThreads) {
        const int i = e / C4, c = (e % C4) * 4;
        const int t = t0 - d + i;
        if (t < 0 || t >= T) continue;
        float4* row = reinterpret_cast<float4*>(sA + (size_t)(dmax - d + i) * LDA + c);
        const float4 xv = *row, sv = *reinterpret_cast<const float4*>(stepl + c);
        *row = make_float4(xv.x + sv.x, xv.y + sv.y, xv.z + sv.z, xv.w + sv.w);
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
        gemm<R>(acc, sA + (size_t)(dmax - d) * LDA, d * LDA, 3, wdl, col0, ring);
        const int cb = col0 + wn * NG * 8 + (lane & 3) * 2;  // this lane's first channel
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt) {
          // every cond value of the m16 tile first, then the gates
          float2 cg_[2][NG], cf_[2][NG];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + (wm * P::MT + mt) * 16 + (lane >> 2) + 8 * h;
            const float* cr = condl + ((size_t)b * T + (t < T ? t : 0)) * C2 + cb;
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              cg_[h][j] = *reinterpret_cast<const float2*>(cr + j * 8);
              cf_[h][j] = *reinterpret_cast<const float2*>(cr + C + j * 8);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (wm * P::MT + mt) * 16 + (lane >> 2) + 8 * h;
            const bool valid = t0 + r < T;
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              const int ch = cb + j * 8;
              float2 gv = make_float2(0.f, 0.f);
              if (valid) {
                const float yg0 = acc[mt][j][2 * h] + bdl[ch] + cg_[h][j].x;
                const float yg1 = acc[mt][j][2 * h + 1] + bdl[ch + 1] + cg_[h][j].y;
                const float yf0 = acc[mt][NG + j][2 * h] + bdl[C + ch] + cf_[h][j].x;
                const float yf1 = acc[mt][NG + j][2 * h + 1] + bdl[C + ch + 1] + cf_[h][j].y;
                gv = make_float2(tanhf(yf0) / (1.f + expf(-yg0)),
                                 tanhf(yf1) / (1.f + expf(-yg1)));
              }
              if constexpr (P::CL > 1) {  // every block of the cluster gets the gate
#pragma unroll
                for (int q = 0; q < P::CL; ++q)
                  *reinterpret_cast<float2*>(cg::this_cluster().map_shared_rank(sG, q) +
                                             (size_t)r * LDA + ch) = gv;
              } else {
                *reinterpret_cast<float2*>(sG + (size_t)r * LDA + ch) = gv;
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
        gemm<R>(acc, sG, 0, 1, wol, col0, ring);
        const int cb = col0 + wn * NG * 8 + (lane & 3) * 2;  // this lane's first channel
#pragma unroll
        for (int mt = 0; mt < P::MT; ++mt) {
          // every x and skip value of the m16 tile first, then the stores
          float2 xm[2][NG], sk[2][NG];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + (wm * P::MT + mt) * 16 + (lane >> 2) + 8 * h;
            const size_t idx = ((size_t)b * T + (t < T ? t : 0)) * C + cb;
#pragma unroll
            for (int j = 0; j < NG; ++j) {
              xm[h][j] = l + 1 < L ? *reinterpret_cast<const float2*>(src + idx + j * 8)
                                   : make_float2(0.f, 0.f);
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
              if (l + 1 < L)
                *reinterpret_cast<float2*>(dst + idx + j * 8) =
                    make_float2((xm[h][j].x + zr0) * kRsqrt2, (xm[h][j].y + zr1) * kRsqrt2);
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
cudaError_t launch(const float* x0, const float* cond, const float* step, const float* wd,
                   const float* bd, const float* wo, const float* bo, float* xbuf, float* skip,
                   int B, int T, int L, int dmax, const Dilations& dil, int sms,
                   cudaStream_t stream) {
  using P = Tile<R>;
  constexpr int CL = P::CL;
  const size_t smem =
      (size_t)(2 * R + 2 * dmax) * P::LDA * sizeof(float) + 2 * P::STAGE * sizeof(uint32_t);
  auto kern = residual_stack_kernel<R>;
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
  err = cudaLaunchKernelEx(&cfg, kern, x0, cond, step, wd, bd, wo, bo, xbuf, skip, B, T, L, dmax,
                           dil);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x0 [B,T,C], cond [L,B,T,2C], step [L,B,C], wd [L,3,C,2C], bd [L,2C],
// wo [L,C,2C], bo [L,2C], all fp32 contiguous on `device`, with C = 256
// (the flagship's width, which the tile shapes and shared-memory sizes
// above are set for); dilations is a host array of L ints; xbuf [2,B,T,C]
// scratch; skip [B,T,C] output. Returns a cudaError_t (0 on success).
int diffnet_residual_stack(const float* x0, const float* cond, const float* step,
                           const float* wd, const float* bd, const float* wo, const float* bo,
                           const int* dilations, float* xbuf, float* skip, int B, int T, int C,
                           int L, int device, void* stream) {
  if (L < 1 || L > kMaxLayers || C != kC || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64-frame tiles where they still give every SM one, else 16-frame tiles
  // over clusters of two
  const bool wide = (long long)B * ((T + 63) / 64) >= sms;
  err = wide ? launch<64>(x0, cond, step, wd, bd, wo, bo, xbuf, skip, B, T, L, dmax, dil, sms, s)
             : launch<16>(x0, cond, step, wd, bd, wo, bo, xbuf, skip, B, T, L, dmax, dil, sms, s);
  return (int)err;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
