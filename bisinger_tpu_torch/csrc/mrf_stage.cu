// K2, fp32 route: one HiFi-GAN MRF stage in one launch, on the tensor cores
// in error-compensated TF32 (3xTF32, `mma_tf32.cuh`).
//
// Replaces bisinger_tpu/ops/mrf_pallas.py:fused_mrf_stage with
// compute_dtype=float32 (bodies _mrf_kernel_static and _mrf_kernel_roll,
// which compute the same function; plan from plan_stage / stage_halo /
// stack_stage_weights). out = mean over blocks j of ResBlock1_j(x), where
// ResBlock1 with kernel k runs, for each dilation d:
//   x <- x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))
// (slope 0.1, biases included, SAME zero padding after every conv). x and
// out are [B, U, F] fp32, and so is every value in between; the weights
// are one flat fp32 buffer of the convs in order (block j, dilation i,
// conv1 then conv2), each laid out [k][F_in][F_out] as the flax kernel;
// biases [n_convs, F].
//
// Bound. 252*F^2 FLOP per sample (three blocks, k = 3 + 7 + 11, six convs
// each) against 8 bytes per sample plus the weights: the operations bound
// it. fp32 accuracy costs three TF32 products per product, so the card's
// least time is the operations at 495 / 3 = 165 TFLOP/s (TF32 tensor
// cores, dense, H100 SXM), against 67 TFLOP/s on the fp32 CUDA cores.
//
// Design (overlap-save, as mrf_stage_bf16.cu). A block owns Uc central
// samples of one sequence and a window of rows around them in shared
// memory: the block state `sx` and conv1's output `st` (stored lrelu'd, the
// only form conv2 reads), both fp32. Block j of the stage starts from the
// rows its own reach needs, and the exact region shrinks by each conv's
// reach; rows outside [0, U) are zeroed after every conv (SAME padding).
// Each conv is an implicit GEMM [rows x k*F] by [k*F x F] on mma.sync
// m16n8k8 TF32 in 3xTF32:
//   - A is read from the window rows shifted by the tap's offset (a
//     dilation is only a row offset; 64-bit loads, rows padded to F + 8
//     floats so that a load's lanes hit distinct banks), a stage ahead of
//     its products at F >= 128, then lrelu'd and split in registers;
//   - B, the weights, comes through a two-slot ring in shared memory: each
//     stage of KC input channels x the block's output columns is read into
//     registers during the previous stage's products, split into hi and lo
//     once per block and stored as 16-byte units, so a lane's four B
//     registers of a k8 step are one 128-bit load (an fp32 ring refilled by
//     cp.async, 3 stages, with the split in every warp's registers ran
//     slower on an H100);
//   - each k8 step's (or pair of steps') three products go into a zeroed
//     partial, the cross terms first, and the partial is added to the sums
//     in fp32; the sums start from the bias. Taken straight into the sums,
//     the products' error grew with a conv's depth, to 2.8e-5 of the
//     largest value at F = 256 against single-pass TF32's 2.8e-4: inside
//     the 10x the card's check asks, but without margin, and above 1e-5;
//     through the partials it reads 2e-7 to 5e-7 at every width (PERF.md).
//     Why the direct sums lose it (the tensor cores' own fp32 adds
//     rounding differently from an FADD, say) was not measured;
//   - eight warps as WM x WN, each up to MT m16 row tiles x NT n8 column
//     tiles; the m16 tiles of a row tile go round the warp rows, and one
//     row tile covers every row of a conv at F >= 128, so each block reads
//     each conv's weights from L2 once there.
//
// Shared memory sets the shape, since every byte of the bf16 design
// doubles: at F = 256 a row of the two windows takes 2 KB, and the 227 KB
// of one SM less the ring hold about 94 rows, under the 2H = 120 halo
// rows. So clusters share a chunk (`Cfg`): CT blocks along time, each
// holding a stretch of the chunk's window and M rows (the widest conv's
// reach) of its neighbours' rows on each inner side, refreshed from the
// neighbours' shared memory (distributed shared memory) after every conv;
// and CC blocks along the channels, each holding F / CC channels and
// computing those output channels, with the others' share of each conv's
// A operand read from their shared memory. The entry point takes:
//   - F = 256: 2 x 2 blocks, 175.7 ms at B=32, T=1024 and 6.1 ms at B=4,
//     T=256, against 194.2 and 6.1 ms along the channels alone (CC = 2,
//     which recomputes the halo 1.7x at Uc = 63) and 293.0 and 10.7 ms
//     along time alone (CT = 4, 44 rows of its own a block);
//   - F = 128: CT = 2, 124.1 ms at B=32 and 4.5 ms at B=4, against 177.1
//     and 5.6 ms for one block a chunk (along the channels, and 2 x 2,
//     ran slower too);
//   - F <= 64: one block a chunk.
// (H100 80GB HBM3 at 700 W; the losing layouts were timed by a probe
// removed with them, PERF.md.)
// Uc is set by shared memory and then cut to the shortest chunks that
// fill as many waves of clusters as the widest would.
//
// Costs above the bound: the halo recompute, the A splits (every warp
// column splits its rows again), a block barrier per weight stage, the
// fp32 adds of the partials, and mma.sync's rate, below wgmma's; wgmma
// takes tf32 only K-major from shared memory, in 64-row tiles that the
// shifted-row taps do not fit (a later step). ptxas (-Xptxas -v, CUDA
// 12.8): 255 registers at every width; spills 28 bytes stored / 44 loaded
// at F = 256, 4 / 4 at F = 128, none at F = 64, 60 / 76 at F = 32; no
// static shared memory (the windows and the ring are dynamic, sized at
// launch to the 227 KB a block may opt into).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "mma_tf32.cuh"

namespace cg = cooperative_groups;
using namespace mma_tf32;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4;
constexpr int kMaxDils = 4;
constexpr float kSlope = 0.1f;

struct Plan {
  int n_blocks, n_dils;
  int k[kMaxBlocks];
  int dil[kMaxBlocks][kMaxDils];
  int reach[kMaxBlocks];
};

// A cluster of CT x CC blocks shares one chunk of samples: CT blocks along
// time (cluster rank / CC), each holding a stretch of the window and M rows
// of its neighbours' on each inner side, and CC blocks along the channels
// (rank % CC), each holding F / CC channels of it and computing those
// output channels.
// FW window channels a block holds and FN output columns it computes; the
// window row stride LDS (= 8 mod 32 floats); KC weight rows (input
// channels) a stage; a stage's weights split into hi and lo as [KC / 2]
// [LDB] units of 16 bytes (LDB = 2 mod 8: a 128-bit B load's lanes hit
// distinct banks), PU units staged per thread; 8 warps as WM x WN, each MT
// m16 x NT n8 tiles, BM rows a row tile (at F >= 128 the widest conv's
// rows, the window less the smallest reach)
template <int F, int CT, int CC>
struct Cfg {
  static constexpr int CL = CT * CC;
  static constexpr int FW = F / CC;
  static constexpr int FN = FW;
  static constexpr int LDS = FW + 8;
  static constexpr int KC = F <= 32 ? 32 : (CT > 1 && CC == 1 && F >= 128) ? 8 : 16;
  static constexpr int KG = KC >= 16 ? 2 : 1;  // k8 steps a partial sum covers
  static constexpr int LDB = FN + 2;
  static constexpr int STAGE = KC / 2 * LDB * 4;  // 32-bit words
  static constexpr int PU = KC / 2 * FN / kThreads;
  static constexpr int WN = FN >= 256 ? 4 : FN >= 64 ? 2 : 1;
  static constexpr int WM = 8 / WN;
  static constexpr int NT = FN / (8 * WN);
  static constexpr int MT = F >= 128 ? 3 : 4;
  static constexpr int BM = 16 * MT * WM;
  static constexpr bool PF = F >= 128;  // A values loaded a stage ahead
  static_assert(NT * 8 * WN == FN && PU * kThreads == KC / 2 * FN, "tiling");
};

__device__ __forceinline__ float2 lrelu2(float2 v) {
  return make_float2(fmaxf(v.x, kSlope * v.x), fmaxf(v.y, kSlope * v.y));
}

// Stage t of one conv's [k][F][F] weights is rows [kc, kc + KC) of tap q,
// columns [c0, c0 + FN). load_b reads this thread's PU pairs of K rows
// (2p, 2p + 1) of one column into registers (neighbouring threads take
// neighbouring columns); store_b splits them and stores unit (p, n) =
// (hi(B[2p][n]), hi(B[2p+1][n]), lo(B[2p][n]), lo(B[2p+1][n])): each
// weight is split once per block, and a lane's four B registers of a k8
// step are one 128-bit load.
template <int F, class G>
__device__ __forceinline__ void load_b(float (&v)[G::PU][2], const float* __restrict__ w, int t,
                                       int c0) {
  constexpr int KT = F / G::KC;
  const float* src = w + ((size_t)(t / KT) * F + (t % KT) * G::KC) * F + c0;
#pragma unroll
  for (int u = 0; u < G::PU; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int p = e / G::FN, n = e % G::FN;
    v[u][0] = __ldg(src + (size_t)(2 * p) * F + n);
    v[u][1] = __ldg(src + (size_t)(2 * p + 1) * F + n);
  }
}

template <class G>
__device__ __forceinline__ void store_b(uint32_t* stage, const float (&v)[G::PU][2]) {
#pragma unroll
  for (int u = 0; u < G::PU; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int p = e / G::FN, n = e % G::FN;
    uint32_t h0, l0, h1, l1;
    split(v[u][0], h0, l0);
    split(v[u][1], h1, l1);
    *reinterpret_cast<uint4*>(stage + (p * G::LDB + n) * 4) = make_uint4(h0, h1, l0, l1);
  }
}

// acc += A @ B over one ring stage, for this warp's first NA m16 tiles: `a`
// is the window at this stage's tap shift and first column (lrelu'd here
// when LRELU), arow this lane's row offsets (rows g and g + 8 of each m16
// tile, column 2t), tb this lane's B values in the stage. Each k8 step's
// three products go into a zeroed partial that is then added to acc in
// fp32: products taken straight into acc read 2.8e-5 of the largest value
// at F = 256 on an H100, against 5e-7 or less so (see the head comment).
template <class G, int NA, bool LRELU>
__device__ __forceinline__ void mma_stage(float (&acc)[G::MT][G::NT][4],
                                          const float2 (&av)[G::KC / 8][G::MT][2],
                                          const uint32_t* tb) {
#pragma unroll
  for (int kg = 0; kg < G::KC / 8; kg += G::KG) {
    uint32_t ah[G::KG][NA][4], al[G::KG][NA][4];
#pragma unroll
    for (int ks = 0; ks < G::KG; ++ks)
#pragma unroll
      for (int mt = 0; mt < NA; ++mt)
        split_a(LRELU ? lrelu2(av[kg + ks][mt][0]) : av[kg + ks][mt][0],
                LRELU ? lrelu2(av[kg + ks][mt][1]) : av[kg + ks][mt][1], ah[ks][mt], al[ks][mt]);
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      uint4 b[G::KG];
#pragma unroll
      for (int ks = 0; ks < G::KG; ++ks)
        b[ks] = *reinterpret_cast<const uint4*>(tb + ((kg + ks) * 4 * G::LDB + nt * 8) * 4);
#pragma unroll
      for (int mt = 0; mt < NA; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < G::KG; ++ks)
          mma3(part, ah[ks][mt], al[ks][mt], b[ks].x, b[ks].y, b[ks].z, b[ks].w);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
      }
    }
  }
}

// mma_stage for the nact (1..MT) m16 tiles this warp has in the row tile
template <class G, bool LRELU>
__device__ __forceinline__ void mma_stage_n(int nact, float (&acc)[G::MT][G::NT][4],
                                            const float2 (&av)[G::KC / 8][G::MT][2],
                                            const uint32_t* tb) {
  if (nact >= G::MT) {
    mma_stage<G, G::MT, LRELU>(acc, av, tb);
  } else if (G::MT > 3 && nact == 3) {
    mma_stage<G, (G::MT > 3 ? 3 : 1), LRELU>(acc, av, tb);
  } else if (nact == 2) {
    mma_stage<G, 2, LRELU>(acc, av, tb);
  } else {
    mma_stage<G, 1, LRELU>(acc, av, tb);
  }
}

// this lane's A values of a stage, for its first nact m16 tiles: `a` is the
// window at the stage's tap shift and first column, arow the lane's row
// offsets (rows g and g + 8 of each m16 tile, column 2t)
template <class G>
__device__ __forceinline__ void load_a(float2 (&av)[G::KC / 8][G::MT][2], const float* a,
                                       const int (&arow)[G::MT][2], int nact) {
#pragma unroll
  for (int ks = 0; ks < G::KC / 8; ++ks)
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
      if (mt < nact)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          av[ks][mt][h] = *reinterpret_cast<const float2*>(a + arow[mt][h] + ks * 8);
}

// Local rows [lo, hi) of dst get  bias + sum_q lrelu(src[row + (q - half) * d]) @ w[q]
// over this block's output columns, zeroed where the sample lies outside
// [0, U). CONV1 (a ResBlock's dilated conv, sx -> st) reads the raw state
// and stores its output lrelu'd, the only form its reader takes; else
// (conv2, st -> sx) the input is lrelu'd already and the output is added
// to dst. The m16 tiles of a row tile go round the warp rows, so that
// every warp row has work while the rows last. With CC > 1, input channel
// f lives in the block of this time stretch with channel rank f / FW.
template <int F, int CT, int CC, bool CONV1>
__device__ void conv(const float* src, float* dst, const float* __restrict__ w,
                     const float* __restrict__ bias, int k, int d, int lo, int hi, int pos0,
                     int U, uint32_t* ring, int rank) {
  using G = Cfg<F, CT, CC>;
  constexpr int KT = F / G::KC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int g = lane >> 2, t = lane & 3;
  const int half = (k - 1) / 2;
  const int ntiles = k * KT;
  const int rc = rank % CC;                  // this block's share of the channels
  const int c0 = rc * G::FW;                 // its first channel
  const int col0 = wn * G::NT * 8;           // this warp's first column of the FN
  for (int m0 = lo; m0 < hi; m0 += G::BM) {
    // m16 tile mt of this warp is the row tile's (mt * WM + wm)-th
    const int n16 = min((hi - m0 + 15) / 16, G::MT * G::WM);
    const int nact = wm < n16 ? (n16 - wm + G::WM - 1) / G::WM : 0;  // the same for the warp
    float acc[G::MT][G::NT][4];  // the sums start from the bias
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const float2 bv =
          __ldg(reinterpret_cast<const float2*>(bias + c0 + col0 + nt * 8 + 2 * t));
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        acc[mt][nt][0] = acc[mt][nt][2] = bv.x;
        acc[mt][nt][1] = acc[mt][nt][3] = bv.y;
      }
    }
    int arow[G::MT][2];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)  // tail rows repeat
        arow[mt][h] = min(m0 + (mt * G::WM + wm) * 16 + g + 8 * h, hi - 1) * G::LDS + 2 * t;
    // the window at stage i's tap shift and first column; with CC > 1
    // the other blocks' channels are read through distributed shared memory
    auto a_at = [&](int i) -> const float* {
      const int kc = (i % KT) * G::KC;
      const int shift = ((i / KT) - half) * d * G::LDS;
      if constexpr (CC > 1) {
        const int owner = kc / G::FW;
        const float* base = owner == rc ? src
                                        : cg::this_cluster().map_shared_rank(
                                              const_cast<float*>(src), rank - rc + owner);
        return base + shift + kc - owner * G::FW;
      } else {
        return src + shift + kc;
      }
    };
    // the next stage's weights (and, with PF, A values) in flight during the products
    float bv[G::PU][2];
    float2 av[G::KC / 8][G::MT][2];
    load_b<F, G>(bv, w, 0, c0);
    if (G::PF) load_a<G>(av, a_at(0), arow, nact);
    for (int i = 0; i < ntiles; ++i) {
      uint32_t* stage = ring + (i & 1) * G::STAGE;
      store_b<G>(stage, bv);
      __syncthreads();  // stage i is in; every thread is done with stage i - 2, its slot
      if (i + 1 < ntiles) load_b<F, G>(bv, w, i + 1, c0);
      if (nact == 0) continue;
      const uint32_t* tb = stage + (t * G::LDB + col0 + g) * 4;
      if constexpr (G::PF) {
        float2 cur[G::KC / 8][G::MT][2];
#pragma unroll
        for (int ks = 0; ks < G::KC / 8; ++ks)
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt) {
            cur[ks][mt][0] = av[ks][mt][0];
            cur[ks][mt][1] = av[ks][mt][1];
          }
        if (i + 1 < ntiles) load_a<G>(av, a_at(i + 1), arow, nact);
        mma_stage_n<G, CONV1>(nact, acc, cur, tb);
      } else {
        load_a<G>(av, a_at(i), arow, nact);
        mma_stage_n<G, CONV1>(nact, acc, av, tb);
      }
    }
    __syncthreads();  // the ring is refilled by the next row tile
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      if (mt >= nact) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + (mt * G::WM + wm) * 16 + g + 8 * h;
        if (r >= hi) continue;
        const int p = pos0 + r;
        const bool inside = p >= 0 && p < U;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          float2* o = reinterpret_cast<float2*>(dst + r * G::LDS + col0 + nt * 8 + 2 * t);
          float2 y = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          if (CONV1) {
            y = lrelu2(y);
          } else {
            const float2 old = *o;
            y = make_float2(old.x + y.x, old.y + y.y);
          }
          *o = inside ? y : make_float2(0.f, 0.f);
        }
      }
    }
  }
}

// every block of the cluster (this block alone when CL == 1) past this point
template <int CL>
__device__ __forceinline__ void sync_blocks() {
  if constexpr (CL > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// After a conv wrote `buf`: every block's writes done, and with CT > 1
// the rows of the time neighbours that this block holds refreshed: local
// rows [0, M) from the previous one's [Lb - 2M, Lb - M), and [Lb - M, Lb)
// from the next one's [M, 2M) (the blocks of the same channels); with
// CC > 1 as well, a second cluster barrier, since the other channels'
// blocks read these rows.
template <int F, int CT, int CC>
__device__ void exchange(float* buf, int Lb, int M, int rank) {
  if constexpr (CT == 1) {
    sync_blocks<CC>();
  } else {
    using G = Cfg<F, CT, CC>;
    constexpr int Q = G::FW / 4;  // float4 chunks per row
    const int rt = rank / CC;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int e = threadIdx.x; e < 2 * M * Q; e += kThreads) {
      const int side = e / (M * Q), r = (e % (M * Q)) / Q, c = (e % Q) * 4;
      const int peer = side == 0 ? rt - 1 : rt + 1;
      if (peer < 0 || peer >= CT) continue;
      const float* from = cluster.map_shared_rank(buf, rank + (peer - rt) * CC) +
                          (size_t)(side == 0 ? Lb - 2 * M + r : M + r) * G::LDS + c;
      *reinterpret_cast<float4*>(buf + (size_t)(side == 0 ? r : Lb - M + r) * G::LDS + c) =
          *reinterpret_cast<const float4*>(from);
    }
    if constexpr (CC > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  }
}

template <int F, int CT, int CC>
__global__ void __launch_bounds__(kThreads, 1) mrf_stage_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* out, int U, int Uc, int H, int M, int Lb, Plan plan) {
  using G = Cfg<F, CT, CC>;
  constexpr int CL = G::CL;
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;
  float* st = sx + (size_t)Lb * G::LDS;
  uint32_t* ring = reinterpret_cast<uint32_t*>(st + (size_t)Lb * G::LDS);
  const int rank = (int)(blockIdx.x % CL);  // in the (CL, 1, 1) cluster
  const int b = blockIdx.y;
  const int u0 = (int)(blockIdx.x / CL) * Uc;
  const int Lt = Uc + 2 * H;  // rows of the cluster's window; row 0 is sample u0 - H
  // this block's local row i is window row base + i; it computes window rows [own_lo, own_hi)
  const int rt = rank / CC;
  const int base = rt * (Lb - 2 * M);
  const int own_lo = rt > 0 ? base + M : 0;
  const int own_hi = rt < CT - 1 ? base + Lb - M : Lt;
  const int pos0 = u0 - H + base;  // sample of local row 0
  const int c0 = (rank % CC) * G::FW;
  const float* xb = x + (size_t)b * U * F + c0;
  float* ob = out + (size_t)b * U * F + c0;
  constexpr int Q = G::FW / 4;  // float4 chunks per row
  size_t woff = 0;
  int slot = 0;
  for (int j = 0; j < plan.n_blocks; ++j) {
    const int k = plan.k[j];
    int lo = H - plan.reach[j], hi = Lt - (H - plan.reach[j]);  // window rows still exact
    const int l0 = max(lo, base) - base, l1 = min(hi, base + Lb) - base;
    for (int e = threadIdx.x; e < (l1 - l0) * Q; e += kThreads) {
      const int i = l0 + e / Q, c = (e % Q) * 4;
      const int p = pos0 + i;
      float* row = sx + (size_t)i * G::LDS + c;
      if (p >= 0 && p < U) {
        cp_async16(row, xb + (size_t)p * F + c);
      } else {
        *reinterpret_cast<float4*>(row) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    sync_blocks<CL>();  // the window is in; no peer still reads the last block's buffers
    for (int i = 0; i < plan.n_dils; ++i) {
      const int d = plan.dil[j][i];
      const int r1 = d * (k - 1) / 2, r2 = (k - 1) / 2;
      lo += r1;
      hi -= r1;
      conv<F, CT, CC, true>(sx, st, w + woff, bias + (size_t)slot * F, k, d,
                           max(lo, own_lo) - base, min(hi, own_hi) - base, pos0, U, ring, rank);
      woff += (size_t)k * F * F;
      ++slot;
      exchange<F, CT, CC>(st, Lb, M, rank);
      lo += r2;
      hi -= r2;
      conv<F, CT, CC, false>(st, sx, w + woff, bias + (size_t)slot * F, k, 1,
                            max(lo, own_lo) - base, min(hi, own_hi) - base, pos0, U, ring, rank);
      woff += (size_t)k * F * F;
      ++slot;
      if (i + 1 < plan.n_dils) {
        exchange<F, CT, CC>(sx, Lb, M, rank);
      } else {
        __syncthreads();
      }
    }
    // the central rows this block computed: window rows [H, H + Uc) of its own
    const int c_lo = max(H, own_lo), c_hi = min(H + Uc, own_hi);
    const int n = c_hi > c_lo ? (c_hi - c_lo) * Q : 0;
    const bool last = j + 1 == plan.n_blocks;
    for (int e0 = threadIdx.x; e0 < n; e0 += 4 * kThreads) {
      float4 prev[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        const int s = u0 + c_lo - H + e / Q;
        prev[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j > 0 && e < n && s < U)
          prev[u] = *reinterpret_cast<const float4*>(ob + (size_t)s * F + (e % Q) * 4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kThreads;
        const int s = u0 + c_lo - H + e / Q;
        if (e >= n || s >= U) continue;
        const float4 sv = *reinterpret_cast<const float4*>(
            sx + (size_t)(c_lo - base + e / Q) * G::LDS + (e % Q) * 4);
        float4 v = make_float4(prev[u].x + sv.x, prev[u].y + sv.y, prev[u].z + sv.z,
                               prev[u].w + sv.w);
        if (last) {
          const float nb = (float)plan.n_blocks;
          v = make_float4(v.x / nb, v.y / nb, v.z / nb, v.w / nb);
        }
        *reinterpret_cast<float4*>(ob + (size_t)s * F + (e % Q) * 4) = v;
      }
    }
    __syncthreads();  // the next block reloads the window
  }
  if constexpr (CL > 1) cg::this_cluster().sync();  // no peer reads this block's memory any more
}

template <int F, int CT, int CC>
cudaError_t launch(const float* x, const float* w, const float* bias, float* out, int B, int U,
                   int H, int M, const Plan& plan, int smem_max, int sms, cudaStream_t stream) {
  using G = Cfg<F, CT, CC>;
  constexpr int CL = G::CL;
  const long long ring = 2LL * G::STAGE * sizeof(uint32_t);
  const long long per_row = 2LL * G::LDS * sizeof(float);
  int Lb = (int)((smem_max - ring) / per_row);
  int Lt = CT * (Lb - 2 * M) + 2 * M;  // the widest chunk's window
  int Uc = Lt - 2 * H;
  if (Uc < 8 || (CT > 1 && Lb < 3 * M)) return cudaErrorInvalidConfiguration;
  auto kern = mrf_stage_kernel<F, CT, CC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(ring + Lb * per_row));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = ring + Lb * per_row;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(CL, B);
  int slots = 0;  // clusters (of one block when CL == 1) resident at once
  if (CL > 1) {
    err = cudaOccupancyMaxActiveClusters(&slots, kern, &cfg);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&slots, kern, kThreads,
                                                        cfg.dynamicSmemBytes);
    slots *= sms;
  }
  if (err != cudaSuccess) return err;
  if (slots < 1) return cudaErrorInvalidConfiguration;
  // the most chunks that take as many waves as the widest chunks do: the
  // shortest chunks (least halo recompute per wave) that fill the waves
  const long long widest = (long long)B * ((U + Uc - 1) / Uc);
  const long long waves = (widest + slots - 1) / slots;
  const long long per_seq = waves * slots / B;
  if (per_seq > 0) {
    const int even = (int)(((U + per_seq - 1) / per_seq + 7) / 8 * 8);
    if (even < Uc) Uc = even;
  }
  if (Uc > U) Uc = U;
  Lt = Uc + 2 * H;
  Lb = CT > 1 ? std::max((Lt - 2 * M + CT - 1) / CT + 2 * M, 3 * M) : Lt;
  cfg.dynamicSmemBytes = ring + Lb * per_row;
  cfg.gridDim = dim3(((U + Uc - 1) / Uc) * CL, B);
  err = cudaLaunchKernelEx(&cfg, kern, x, w, bias, out, U, Uc, H, M, Lb, plan);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out [B,U,F] fp32 contiguous on `device`; w, bias as described above;
// ks [n_blocks] and dils [n_blocks * n_dils] are host arrays (odd kernels).
// Returns a cudaError_t (0 on success).
int mrf_stage(const float* x, const float* w, const float* bias, float* out, int B, int U, int F,
              int n_blocks, int n_dils, const int* ks, const int* dils, int device, void* stream) {
  if (B < 1 || U < 1 || n_blocks < 1 || n_blocks > kMaxBlocks || n_dils < 1 ||
      n_dils > kMaxDils)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.n_blocks = n_blocks;
  plan.n_dils = n_dils;
  int H = 0, M = 0;
  for (int j = 0; j < n_blocks; ++j) {
    if (ks[j] < 1 || ks[j] % 2 == 0) return (int)cudaErrorInvalidValue;
    plan.k[j] = ks[j];
    int reach = 0;
    for (int i = 0; i < n_dils; ++i) {
      plan.dil[j][i] = dils[j * n_dils + i];
      if (plan.dil[j][i] < 1) return (int)cudaErrorInvalidValue;
      const int r1 = plan.dil[j][i] * (ks[j] - 1) / 2;
      reach += r1 + (ks[j] - 1) / 2;
      M = r1 > M ? r1 : M;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 32: err = launch<32, 1, 1>(x, w, bias, out, B, U, H, M, plan, smem_max, sms, s); break;
    case 64: err = launch<64, 1, 1>(x, w, bias, out, B, U, H, M, plan, smem_max, sms, s); break;
    case 128: err = launch<128, 2, 1>(x, w, bias, out, B, U, H, M, plan, smem_max, sms, s); break;
    case 256: err = launch<256, 2, 2>(x, w, bias, out, B, U, H, M, plan, smem_max, sms, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
