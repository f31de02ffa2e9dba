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
// Bound. 252*F^2 FLOP per sample (three blocks, k = 3 + 7 + 11, six convs
// each) against 8 bytes per sample plus the weights: the operations bound
// it (bf16 tensor cores, 989 TFLOP/s dense on an H100 SXM). What the
// design pays above that: the halo recompute, a barrier and a wait per
// weight stage, and the weights read from L2 once per row tile.
//
// Design (overlap-save, as mrf_stage.cu). A cluster of CT blocks along time
// owns one sequence b and a chunk of Uc samples, with a window of
// Lt = Uc + 2H rows (H = the widest block's receptive field per side).
// Block r of the cluster holds window rows [r (Lb - 2M), r (Lb - 2M) + Lb)
// in shared memory, the state `sx` and conv1's output `st`, both bf16, and
// computes its own rows of each conv: all it holds but the M rows (the
// widest conv1's reach) that overlap each time neighbour. After every conv
// those M edge rows are refreshed from the neighbours' shared memory
// (`exchange`: a cluster barrier, then reads through
// cg::this_cluster().map_shared_rank, then a block barrier), so the halo
// is recomputed only at the cluster's two outer edges. ResBlock j of the
// stage starts from the rows its own reach needs (H - reach_j trimmed off
// each side) and the exact region shrinks by each conv's reach.
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
// rows a row tile at F = 256 cover the rows a block computes, so a block
// reads each conv's weights from L2 once.
//
// Layouts by width, chosen by timing on an H100 80GB HBM3 at 700 W (PERF.md
// §6; only the layouts taken are built):
//   - F = 256: a cluster of CT = 2 blocks, each stage waiting for its
//     products (23.6-24.0 ms a stage at B=32, T=1024 against cuDNN's
//     conv1d chain at 26.2-26.3 ms and the first design's 38.3-40.0 ms;
//     CT = 4 23.7, products in flight 25.5, 16- and 32-row stages behind a
//     ring of 2 35.2 / 28.5, passes of 128 columns 34.9-36.4); one block a
//     chunk where that takes one wave of blocks or less (B=4, T=256);
//   - F = 128: CT = 2, products in flight (15.9 ms at B=32 against 16.5
//     without, 18.9 for one block a chunk);
//   - F <= 64: one block a chunk (their windows hold 3x or more own rows
//     per halo row already), products in flight; F = 16 and 8 the same,
//     on m64n16k16 and m64n8k16 products, F = 8 with K padded to 16 by 8
//     zero channels in the window rows and zero rows in the weight tiles;
//   - F = 512: a block's window holds only 99 rows (against 2H = 120 halo
//     rows at the flagship's kernels and dilations), so a chunk is shared
//     by a cluster of CT = 8 blocks along time (Uc = 322: 1.37x the rows
//     computed), and each row tile runs in two passes of 256 columns, 128
//     sums a thread: 235.5 ms at B=32, T=1024 (U=8192) and 8.66 ms at B=4,
//     T=256 on an H100, against CT = 4's 297.8 / 12.80, CT = 2's 658.7 /
//     22.76, CT = 4 with 32-row stages 444.6 / 16.06 and with products in
//     flight 327.1 / 12.75 (those layouts are no longer built). It loses
//     to cuDNN's conv1d chain (187.7 / 7.9 ms): each block streams a conv's
//     5.8 MB of weights through 8 KB stages, a block barrier each, for the
//     50 rows it owns.
// The first design, one block a chunk at every width, recomputed the widest
// ResBlock's halo 2.58x at F = 256 (Uc = 76 in a 196-row window) and lost
// to cuDNN there. lrelu is two bf16x2 instructions (max(v, slope * v)),
// where a branch on the signs in every lane stood (PERF.md: the stages
// read 14-50% faster in the next run on the same card model).
// ptxas (CUDA 12.8), the layouts taken: 168 registers at F = 256 and 128
// (the 384 threads' share), spilling 540 bytes at F = 256 and 96 at F =
// 128 (with products in flight); F = 64 168 registers, 96 bytes; F = 32
// 158, none; F = 512 158 (162 with 32-row stages), none; F = 16 100 and
// F = 8 96, none. One library a width (-DKERNEL_WIDTH, ops/_build.py
// K2_WIDTHS) builds its own layouts.
//
// Barriers, and what each answers. The weight ring keeps cp.async and a
// block barrier per stage, which every thread passes: a ring of bulk
// copies behind full/empty mbarriers, refilled by thread 0 of the first
// warpgroup with no block barrier, ran faster on an H100 but deadlocked
// within 50 to 200 back-to-back launches in each of three runs (the
// likely cause: thread 0 spinning on an empty barrier inside a warp whose
// other lanes went on to the warp-aligned wgmma instructions; K1's wide
// path, diffnet_stack_bf16.cu, gives its ring a producer warp of its own
// for that reason). Here:
//   - `exchange` opens with a cluster barrier: every block of the cluster
//     finished writing the conv's rows before any reads its edge rows; it
//     closes with a block barrier: the copied rows are in before the next
//     conv reads them. The next write of the same buffer comes after the
//     next exchange's cluster barrier, after every peer's reads;
//   - the window load ends at a cluster barrier: no peer still reads the
//     previous ResBlock's buffers when they are refilled;
//   - the last cluster barrier keeps every block resident until no peer
//     reads its shared memory any more;
//   - the ring's stage barrier follows cp.async.wait_group and a
//     fence.proxy.async (the cp.async writes are generic-proxy writes,
//     which wgmma reads through the async proxy); it also orders the
//     refill of a slot after every warpgroup's wgmma_wait on the stage
//     that read it last (the stage before, or with products in flight the
//     one before that, which is why that ring is a stage deeper).
// No mbarrier and no bulk copy: no transaction counts or phase parity to
// keep.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;
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

// lrelu of two bf16 values: max(v, bf16(slope * v)), the product rounded to
// bf16 once (a bf16 product is exact in fp32 before the rounding), the same
// values as the rounding of slope * v in fp32 for v < 0, and v for v >= 0
__device__ __forceinline__ uint32_t lrelu2(uint32_t v) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const __nv_bfloat162 y = __hmax2(x, __hmul2(x, __float2bfloat162_rn(kSlope)));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// three warpgroups own MT m64 row tiles each (BM rows together) over NW
// output columns a pass (all F up to 256; F = 512 in two passes of 256:
// F / 2 sums a thread would not fit in its registers), NW / 2 fp32 sums a
// thread per m64 tile; KC weight rows a ring stage. K runs over FK >= 16
// input channels: at F = 8 the window rows and the weight tiles carry 8
// zero channels, since a wgmma step is 16 deep. PIPE: a stage's products
// stay in flight across the next stage's barrier (wgmma_wait<1>, two A
// register sets), the ring one stage deeper and loaded NS - 2 tiles ahead;
// else each stage waits for its products and the ring loads NS - 1 ahead.
template <int F, int KC_, bool PIPE_>
struct Cfg {
  static constexpr int NWG = 3;
  static constexpr int THREADS = 128 * NWG;
  static constexpr int MT = F >= 256 ? 1 : 2;
  static constexpr int BM = 64 * MT * NWG;
  static constexpr int FK = F < 16 ? 16 : F;  // input channels as K sees them
  static constexpr int LDS = FK + 8;  // window row stride: ldmatrix rows hit distinct banks
  static constexpr int NW = F > 256 ? 256 : F;  // output columns a pass
  static constexpr int NPASS = F / NW;
  static constexpr int KC = KC_;
  static constexpr bool PIPE = PIPE_;
  static constexpr int NS = PIPE ? 4 : 3;  // ring stages
  static constexpr int AHEAD = PIPE ? NS - 2 : NS - 1;  // tiles loaded ahead
  static constexpr int TILE = KC * NW;  // core-matrix layout, no padding
  static_assert(KC % 16 == 0 && FK % KC == 0 && F % NW == 0, "stage depth");
};

// ring stage <- rows [kc, kc + KC) of tap q of one conv's [k][F][F] weights,
// columns [col0, col0 + NW), as the core matrices of an MN-major wgmma B
// operand: core (K group g, N group n) at element (n * KC / 8 + g) * 64,
// its K-row r % 8 at 8 more; K rows at F and above (F = 8) are zeros
template <int F, class G>
__device__ __forceinline__ void load_tile(bf16* slot, const bf16* __restrict__ w, int t,
                                          int col0) {
  constexpr int KC = G::KC, KT = G::FK / KC, NW = G::NW;
  const int kc = (t % KT) * KC;
  const bf16* src = w + ((size_t)(t / KT) * F + kc) * F + col0;
  for (int c = threadIdx.x; c < KC * (NW / 8); c += G::THREADS) {
    const int r = c % KC, n = c / KC;  // neighbouring threads fill neighbouring rows
    bf16* dst = slot + (n * (KC / 8) + r / 8) * 64 + (r % 8) * 8;
    if (F >= 16 || kc + r < F) {
      cp_async16(dst, src + (size_t)r * F + n * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Rows [lo, hi) of dst get  bias + sum_q lrelu(src[row + (q - half) * d]) @ w[q]
// (added to dst in fp32 when `residual`), rounded to bf16, zeroed where the
// sample lies outside [0, U); row i is sample pos0 + i.
template <int F, int KC, bool PIPE>
__device__ void conv(const bf16* src, bf16* dst, const bf16* __restrict__ w,
                     const float* __restrict__ bias, int k, int d, int lo, int hi,
                     bool residual, int pos0, int U, bf16* ring) {
  using G = Cfg<F, KC, PIPE>;
  constexpr int KT = G::FK / KC, NW = G::NW;
  constexpr int NA = NW / 2;  // accumulators per thread per m64 tile
  constexpr uint32_t kLbo = 128, kSbo = KC * 16;  // core-matrix steps along K and N, bytes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int half = (k - 1) / 2;
  const int ntiles = k * KT;
  for (int m0 = lo; m0 < hi; m0 += G::BM) {
    for (int col0 = 0; col0 < F; col0 += NW) {  // the passes over the output columns
      const int r0 = m0 + wg * G::MT * 64;  // this warpgroup's first row
      const bool active = r0 < hi;          // the same for the whole warpgroup
      float acc[G::MT][NA];  // the sums start from the bias
#pragma unroll
      for (int nt = 0; nt < NW / 8; ++nt) {
        const float2 bv =
            __ldg(reinterpret_cast<const float2*>(bias + col0 + nt * 8 + (lane & 3) * 2));
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
      for (int s = 0; s < G::AHEAD; ++s) {
        if (s < ntiles) load_tile<F, G>(ring + s * G::TILE, w, s, col0);
        cp_async_commit();
      }
      uint32_t a[2][KC / 16][G::MT][4];  // this stage's A, and (PIPE) the previous one's
      // stage i: tile i landed for every thread and the slot it refills free, its
      // A into a[h], its products issued
      auto stage = [&](int i, uint32_t(&ah)[KC / 16][G::MT][4]) {
        cp_async_wait<G::AHEAD - 1>();
        fence_proxy_async();
        // tile i landed for every thread; the products of the stage whose slot
        // is refilled now (i - 1, or with PIPE i - 2) are done in every warpgroup
        __syncthreads();
        const int nx = i + G::AHEAD;
        if (nx < ntiles) load_tile<F, G>(ring + (nx % G::NS) * G::TILE, w, nx, col0);
        cp_async_commit();
        if (!active) return;
        const bf16* tb = ring + (i % G::NS) * G::TILE;
        const int aoff = ((i / KT) - half) * d * G::LDS + (i % KT) * KC;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt) {
            ldmatrix_a(ah[ks][mt], arow[mt] + aoff + ks * 16);
#pragma unroll
            for (int e = 0; e < 4; ++e) ah[ks][mt][e] = lrelu2(ah[ks][mt][e]);
          }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          const uint64_t desc = smem_desc(tb + ks * 128, kLbo, kSbo);  // K groups 2ks, 2ks + 1
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt) wgmma_rs<NW>(acc[mt], ah[ks][mt], desc, 1);
        }
        wgmma_commit();
        if constexpr (PIPE) {
          wgmma_wait<1>();  // the previous stage's products (and its A registers) are done
        } else {
          wgmma_wait<0>();
        }
      };
      for (int i = 0; i < ntiles; i += 2) {  // the A register sets alternate
        stage(i, a[0]);
        if (i + 1 < ntiles) stage(i + 1, a[1]);
      }
      if constexpr (PIPE) wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
        for (int e = 0; e < NA; ++e) reg_fence(acc[mt][e]);
      __syncthreads();  // the ring is refilled by the next row tile or pass
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
          for (int nt = 0; nt < NW / 8; ++nt) {
            const int col = col0 + nt * 8 + (lane & 3) * 2;
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
}

// every block of the cluster (this block alone when CT == 1) past this point
template <int CT>
__device__ __forceinline__ void sync_blocks() {
  if constexpr (CT > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// After a conv wrote `buf`: every block's writes done, and with CT > 1 the
// rows of the time neighbours that this block holds refreshed: local rows
// [0, M) from the previous block's [Lb - 2M, Lb - M), and [Lb - M, Lb) from
// the next one's [M, 2M).
template <int F, int CT, int THREADS>
__device__ void exchange(bf16* buf, int Lb, int M, int rank) {
  if constexpr (CT == 1) {
    __syncthreads();
  } else {
    constexpr int LDS = F + 8;
    constexpr int Q = F / 8;  // 16-byte chunks per row
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int e = threadIdx.x; e < 2 * M * Q; e += THREADS) {
      const int side = e / (M * Q), r = (e % (M * Q)) / Q, c = (e % Q) * 8;
      const int peer = side == 0 ? rank - 1 : rank + 1;
      if (peer < 0 || peer >= CT) continue;
      const bf16* from = cluster.map_shared_rank(buf, peer) +
                         (size_t)(side == 0 ? Lb - 2 * M + r : M + r) * LDS + c;
      *reinterpret_cast<uint4*>(buf + (size_t)(side == 0 ? r : Lb - M + r) * LDS + c) =
          *reinterpret_cast<const uint4*>(from);
    }
    __syncthreads();
  }
}

template <int F, int CT, int KC, bool PIPE>
__global__ void __launch_bounds__(Cfg<F, KC, PIPE>::THREADS, 1) mrf_stage_bf16_kernel(
    const float* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
    float* out, int U, int Uc, int H, int M, int Lb, Plan plan) {
  using G = Cfg<F, KC, PIPE>;
  constexpr int NTH = G::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sx = reinterpret_cast<bf16*>(smem_raw);
  bf16* st = sx + (size_t)Lb * G::LDS;
  bf16* ring = st + (size_t)Lb * G::LDS;
  const int rank = (int)(blockIdx.x % CT);  // in the (CT, 1, 1) cluster
  const int b = blockIdx.y;
  const int u0 = (int)(blockIdx.x / CT) * Uc;
  const int Lt = Uc + 2 * H;  // rows of the cluster's window; row 0 is sample u0 - H
  // this block's local row i is window row base + i; it computes window rows [own_lo, own_hi)
  const int base = rank * (Lb - 2 * M);
  const int own_lo = rank > 0 ? base + M : 0;
  const int own_hi = rank < CT - 1 ? base + Lb - M : Lt;
  const int pos0 = u0 - H + base;  // sample of local row 0
  const float* xb = x + (size_t)b * U * F;
  float* ob = out + (size_t)b * U * F;
  constexpr int Q = F / 4;  // float4 chunks per row
  if constexpr (G::FK > F) {  // the zero channels K reads past F (F = 8), in both buffers
    constexpr int QP = (G::FK - F) / 8;  // 16-byte chunks of them a row
    for (int e = threadIdx.x; e < 2 * Lb * QP; e += NTH)
      *reinterpret_cast<uint4*>(sx + (size_t)(e / QP) * G::LDS + F + (e % QP) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  size_t woff = 0;
  int slot = 0;
  for (int j = 0; j < plan.n_blocks; ++j) {
    const int k = plan.k[j];
    int lo = H - plan.reach[j], hi = Lt - (H - plan.reach[j]);  // window rows still exact
    const int l0 = max(lo, base) - base, l1 = min(hi, base + Lb) - base;
    // four float4 loads in flight per thread, then their bf16 stores
    for (int e0 = threadIdx.x; e0 < (l1 - l0) * Q; e0 += 4 * NTH) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NTH;
        const int p = pos0 + l0 + e / Q;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < (l1 - l0) * Q && p >= 0 && p < U)
          v[u] = *reinterpret_cast<const float4*>(xb + (size_t)p * F + (e % Q) * 4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NTH;
        if (e < (l1 - l0) * Q)
          *reinterpret_cast<uint2*>(sx + (l0 + e / Q) * G::LDS + (e % Q) * 4) =
              make_uint2(pack_bf16x2(v[u].x, v[u].y), pack_bf16x2(v[u].z, v[u].w));
      }
    }
    sync_blocks<CT>();  // the window is in; no peer still reads the last ResBlock's buffers
    for (int i = 0; i < plan.n_dils; ++i) {
      const int d = plan.dil[j][i];
      const int r1 = d * (k - 1) / 2, r2 = (k - 1) / 2;
      lo += r1;
      hi -= r1;
      conv<F, KC, PIPE>(sx, st, w + woff, bias + (size_t)slot * F, k, d, max(lo, own_lo) - base,
                  min(hi, own_hi) - base, false, pos0, U, ring);
      woff += (size_t)k * F * F;
      ++slot;
      exchange<F, CT, NTH>(st, Lb, M, rank);
      lo += r2;
      hi -= r2;
      conv<F, KC, PIPE>(st, sx, w + woff, bias + (size_t)slot * F, k, 1, max(lo, own_lo) - base,
                  min(hi, own_hi) - base, true, pos0, U, ring);
      woff += (size_t)k * F * F;
      ++slot;
      if (i + 1 < plan.n_dils) {
        exchange<F, CT, NTH>(sx, Lb, M, rank);
      } else {
        __syncthreads();
      }
    }
    // the central rows this block computed: window rows [H, H + Uc) of its own
    const int c_lo = max(H, own_lo), c_hi = min(H + Uc, own_hi);
    const int n = c_hi > c_lo ? (c_hi - c_lo) * Q : 0;
    const bool last = j + 1 == plan.n_blocks;
    for (int e0 = threadIdx.x; e0 < n; e0 += 4 * NTH) {
      float4 prev[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NTH;
        const int s = u0 + c_lo - H + e / Q;
        prev[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j > 0 && e < n && s < U)
          prev[u] = *reinterpret_cast<const float4*>(ob + (size_t)s * F + (e % Q) * 4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * NTH;
        const int s = u0 + c_lo - H + e / Q;
        if (e >= n || s >= U) continue;
        const uint2 sv = *reinterpret_cast<const uint2*>(
            sx + (size_t)(c_lo - base + e / Q) * G::LDS + (e % Q) * 4);
        const float2 s01 = unpack_bf16x2(sv.x), s23 = unpack_bf16x2(sv.y);
        float4 v = make_float4(prev[u].x + s01.x, prev[u].y + s01.y, prev[u].z + s23.x,
                               prev[u].w + s23.y);
        if (last) {
          const float nb = (float)plan.n_blocks;
          v = make_float4(v.x / nb, v.y / nb, v.z / nb, v.w / nb);
        }
        *reinterpret_cast<float4*>(ob + (size_t)s * F + (e % Q) * 4) = v;
      }
    }
    __syncthreads();  // the next ResBlock reloads the window
  }
  if constexpr (CT > 1) cg::this_cluster().sync();  // no peer reads this block's memory any more
}

template <int F, int CT, int KC, bool PIPE>
cudaError_t launch(const float* x, const bf16* w, const float* bias, float* out, int B, int U,
                   int H, int M, const Plan& plan, int smem_max, int sms, cudaStream_t stream) {
  using G = Cfg<F, KC, PIPE>;
  const long long ring = (long long)G::NS * G::TILE * sizeof(bf16);
  const long long per_row = 2LL * G::LDS * sizeof(bf16);
  int Lb = (int)((smem_max - ring) / per_row);
  int Lt = CT * (Lb - 2 * M) + 2 * M;  // the widest chunk's window
  int Uc = Lt - 2 * H;
  if (Uc < 16 || (CT > 1 && Lb < 3 * M)) return cudaErrorInvalidConfiguration;
  auto kern = mrf_stage_bf16_kernel<F, CT, KC, PIPE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(ring + Lb * per_row));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = ring + Lb * per_row;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(CT, B);
  int slots = 0;  // clusters (of one block when CT == 1) resident at once
  if (CT > 1) {
    err = cudaOccupancyMaxActiveClusters(&slots, kern, &cfg);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&slots, kern, G::THREADS,
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
    const int even = (int)(((U + per_seq - 1) / per_seq + 15) / 16 * 16);
    if (even < Uc) Uc = even;
  }
  if (Uc > U) Uc = U;
  Lt = Uc + 2 * H;
  Lb = CT > 1 ? std::max((Lt - 2 * M + CT - 1) / CT + 2 * M, 3 * M) : Lt;
  cfg.dynamicSmemBytes = ring + Lb * per_row;
  cfg.gridDim = dim3(((U + Uc - 1) / Uc) * CT, B);
  err = cudaLaunchKernelEx(&cfg, kern, x, w, bias, out, U, Uc, H, M, Lb, plan);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The layouts, as (F, CT, KC, PIPE): the one each width takes (two at F =
// 256; mrf_stage_bf16 chooses); a library builds those of its width
#define MRF_BF16_LAYOUTS(X) \
  X(512, 8, 16, 0)          \
  X(256, 1, 16, 0)          \
  X(256, 2, 16, 0)          \
  X(128, 2, 16, 1)          \
  X(64, 1, 32, 1)           \
  X(32, 1, 32, 1)           \
  X(16, 1, 16, 1)           \
  X(8, 1, 16, 1)

#ifndef KERNEL_WIDTH
#error "build with -DKERNEL_WIDTH=<F> (ops/_build.py WIDTHS lists the widths)"
#endif
constexpr int kF = KERNEL_WIDTH;  // this library's width

// the launch of layout (ct, kc, pipe) at this library's width F
template <int F>
cudaError_t dispatch(int ct, int kc, int pipe, const float* x, const bf16* w, const float* bias,
                     float* out, int B, int U, int H, int M, const Plan& plan, int smem_max,
                     int sms, cudaStream_t s) {
#define MRF_BF16_CASE(f, c, k, p)                                                          \
  if constexpr (F == f) {                                                                  \
    if (ct == c && kc == k && pipe == p)                                                   \
      return launch<f, c, k, (p != 0)>(x, w, bias, out, B, U, H, M, plan, smem_max, sms, s); \
  }
  MRF_BF16_LAYOUTS(MRF_BF16_CASE)
#undef MRF_BF16_CASE
  return cudaErrorInvalidValue;
}

// the plan of a stage; returns a cudaError_t (0 on success)
int make_plan(int n_blocks, int n_dils, const int* ks, const int* dils, Plan& plan, int& H,
              int& M) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || n_dils < 1 || n_dils > kMaxDils)
    return (int)cudaErrorInvalidValue;
  plan.n_blocks = n_blocks;
  plan.n_dils = n_dils;
  H = 0;
  M = 0;
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
  return 0;
}

}  // namespace

extern "C" {

// x, out [B,U,F] fp32 contiguous on `device`, F = KERNEL_WIDTH (the width
// this library is built for); w bf16 and bias fp32 as described above; ks
// [n_blocks] and dils [n_blocks * n_dils] are host arrays (odd kernels).
// The layout of each width: F = 512 clusters of eight along time (a block's
// window holds 99 rows at F = 512, under the 2H = 120 halo rows of the
// flagship's widest ResBlock); F = 256 clusters of two along time where one
// block a chunk would take more than one wave of blocks (the bench's B=32),
// else one block a chunk (B=4, T=256: the same blocks, and no cluster
// barriers); F = 128 clusters of two, products in flight; F <= 64 one
// block a chunk, products in flight. Returns a cudaError_t (0 on success).
int mrf_stage_bf16(const float* x, const void* w, const float* bias, float* out, int B, int U,
                   int F, int n_blocks, int n_dils, const int* ks, const int* dils, int device,
                   void* stream) {
  if (B < 1 || U < 1 || F != kF) return (int)cudaErrorInvalidValue;
  Plan plan;
  int H = 0, M = 0, smem_max = 0, sms = 0;
  int err = make_plan(n_blocks, n_dils, ks, dils, plan, H, M);
  if (err != 0) return err;
  err = (int)cudaSetDevice(device);
  if (err != 0) return err;
  err = (int)cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != 0) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != 0) return err;
  int ct = 1, kc = 32, pipe = 1;
  switch (F) {
    case 256: {
      using G = Cfg<256, 16, false>;
      const long long ring = (long long)G::NS * G::TILE * sizeof(bf16);
      const long long uc = (smem_max - ring) / (2LL * G::LDS * sizeof(bf16)) - 2 * H;
      ct = uc > 0 && (long long)B * ((U + uc - 1) / uc) <= sms ? 1 : 2;
      kc = 16;
      pipe = 0;
      break;
    }
    case 512: ct = 8; kc = 16; pipe = 0; break;
    case 128: ct = 2; kc = 16; break;
    case 64: case 32: break;
    case 16: case 8: kc = 16; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch<kF>(ct, kc, pipe, x, static_cast<const bf16*>(w), bias, out, B, U, H, M,
                           plan, smem_max, sms, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
