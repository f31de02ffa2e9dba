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
// In the write-last mode the last layer's x is stored as well (a pipeline
// stage hands it to the next stage); by default it is never formed.
//
// Widths: one library a width C (-DKERNEL_WIDTH, every multiple of 32 from
// 32 to 512: ops/_build.py K1_WIDTHS); the narrow path at every C, the wide
// one where C % 64 == 0. ptxas (CUDA 12.8, -Xptxas -v, every width built):
// the wide kernel 168 registers at C <= 256 (the share of 288 threads
// counted as three warpgroups), 195-199 at C = 320-512 (160 threads: one
// consumer warpgroup and the producer warp), no spill at any C; the narrow
// one 96-136, no spill (C = 256: 128; before C was a template parameter,
// 163).
//
// Bound. 16*C^2 FLOP per frame per layer (3 taps C->2C, a 1x1 C->2C):
// 687 GFLOP per call at B=32, T=1024, C=256, L=20 against ~0.8 GB of bf16
// inputs: the operations bound it (989 TFLOP/s bf16 dense on an H100 SXM,
// 0.695 ms); below C = 96 the bytes do (the cond_proj reads grow with C,
// the products with C^2). Above that the design pays the device-memory round trips of
// the state between layers (below) and, at the small batch, the SMs the
// frames cannot fill.
//
// Common to both paths: the hidden state goes through device memory between
// layers (bf16 ping-pong buffers) behind a grid barrier (cooperative
// launch), and blocks walk tiles of R frames of one sequence, the same
// tiles in every layer. Per tile, a block stages the window a (R + 2*dmax
// rows) in shared memory and computes both products as GEMMs on the tensor
// cores: the dilated taps read the window rows shifted by -d, 0, +d
// through ldmatrix, so a tap is only a row offset. A thread's sums pair
// gate channel c with filter channel C+c (and residual c with skip C+c),
// so the gate is formed in registers and written, bf16, to an [R, C]
// buffer in shared memory, the A operand of the 1x1 GEMM.
//
// The fp32 skip sum stays in device memory: it is read and written once a
// layer (about 1.3 GB a call at B=32, T=1024). Keeping it on chip would
// need each tile's 128 KB of sums resident for all 20 layers, which only
// one tile per SM could have (the bench's 256 tiles need two waves), and
// rounding it to bf16 would move a rounding point the TPU kernel keeps.
//
// Two paths, by the tiles a call has (`wide` in the entry point):
//
// Wide (C % 64 == 0, from 32 128-frame tiles, `kWideTiles`: the bench's
// B=32, T=1024, and B=4, T=1024):
// `residual_stack_bf16_wgmma_kernel<C>`. 128-frame tiles, one block of two
// consumer warpgroups and one producer warp per SM; above C = 256 the
// window and the gate buffer of 128 frames do not fit beside the ring, and
// a tile is 64 frames, one consumer warpgroup (`wide::W`). A GEMM runs in
// 2C / 128 passes of C / 64 stages a tap, an odd count of stages where C /
// 64 is odd (`consume`'s last pair then has one); the pack holds 4 (C /
// 64)^2 stages a layer. Each consumer
// warpgroup owns 64 rows of the tile and runs wgmma.mma_async m64n128k16
// with A from registers (ldmatrix; a tap's row offset d is no multiple of
// 8, which a shared-memory descriptor needs) and B, the weights, from a
// ring in shared memory. Each GEMM runs in four passes of 64
// channels and their partners: 64 fp32 sums a thread (the block's 288
// threads get 168 registers each, as three warpgroups would, and passes of
// 128 channels, 128 sums a thread, spilled 1.7 KB a thread and ran 4.9 ms
// at B=32, T=1024 on an H100). The products of a stage stay in flight
// while the next stage's A is loaded (wgmma_wait<1>, A registers double
// buffered); no block barrier is taken per stage. The ring has 5 stages
// of 16 KB (4 ran 1-3% slower). The weights are packed
// on the host once per set of parameters (ops/diffnet_stack.py
// `pack_weights_bf16`) into the ring's exact order and layout, 64 stages of
// 16 KB a layer (the dilated conv's 4 passes of 12 stages, then the 1x1's
// 4 passes of 4; in each stage 64 K-rows x 128 columns, the columns
// interleaved gate/filter (residual/skip) by n8 tile, stored as the
// MN-major core matrices of the wgmma B operand), so each stage is one
// 1-D bulk copy (cp.async.bulk) that the producer warp issues behind
// full/empty mbarriers. The producer runs up to the ring's depth ahead,
// across passes, tiles and, before each grid barrier, into the next layer.
// One block a tile reads the layer's 1 MB of weights from L2 once per 128
// frames, as the first design did through 64-row stages behind a block
// barrier each. Pairs of blocks sharing each stage by multicast (once per
// 256 frames) ran no faster on an H100 (-2.2% to +2.3% in nine runs at
// B=32, T=1024, PERF.md) and were removed: L2 does not bound the kernel, and
// neither does the ring's depth. 256 rows a block would halve the reads as
// well, but the window and the gate buffer of 256 rows do not fit beside a
// ring. What is left, about 4x the operations bound at B=32, is the
// epilogues (on an H100: 3.05 ms as built, 0.67 without the epilogues,
// 2.64 without the products, PERF.md): their reads of cond, x and skip, in
// short dependent batches at 8 warps an SM, which both warpgroups reach
// together while the tensor cores wait. Reading them ahead into registers
// spilled; an L2 prefetch of the rows, and the rows staged in shared memory
// by cp.async (the ring cut to 3 stages for room), ran slower.
// Barriers of the wide path and the hazard each answers:
//   - full[s] (count 1: the producer's arrive with expect_tx) and empty[s]
//     (count 8: lane 0 of each consumer warp, after the wgmma_wait that
//     retires the stage's products) for each ring slot s; thread 0
//     initialises them, then fence.mbarrier_init and a block barrier before
//     the roles split, so no copy reaches a barrier that does not exist yet;
//   - expect_tx is kStageBytes, the one copy that lands in the slot;
//   - both roles walk the same sequence of stages over layers, tiles and
//     passes, each keeping its ring position (`Ring`: slot, and the parity
//     of the slot's phase, flipped at each wrap): consumers wait on full
//     with that parity, the producer on empty with the other (the phase of
//     the stage NS before); 64 stages a tile-layer are no multiple of NS =
//     5, and nothing relies on one; a waiter is never two phases behind,
//     since a slot is refilled only after every consumer released it;
//   - the producer warp runs as a whole warp (lane 0 issues, __syncwarp),
//     takes every grid barrier at the same code point as the consumers,
//     issues before a grid barrier only stages whose slots the consumers
//     free before it, and before it returns waits until the consumers have
//     released the last NS stages;
//   - no thread writes a ring slot: the bulk copy writes it and wgmma reads
//     it, both in the async proxy, ordered through the mbarriers;
//   - the window and the gate buffer are written and read by threads
//     (cp.async, st.shared, ldmatrix: the generic proxy): a named barrier of
//     the 256 consumer threads orders the window (loaded, step added, then
//     read by both warpgroups, then reloaded); a warp reads back only the
//     gate rows it wrote itself (__syncwarp).
//
// Narrow (fewer tiles, as at B=4, T=256: 8 tiles, where 16-frame tiles over
// 128 blocks fill the card and the wide path's 8 blocks do not; and every
// C % 64 != 0): `residual_stack_bf16_kernel<C>`, mma.sync m16n8k16. At C =
// 256 (and 512), 16-frame tiles split over a cluster of two blocks,
// each owning half the channels (half the weights) and sending its half
// of the gate to both blocks' buffers through distributed shared memory
// before the 1x1 (a cluster barrier each way), 128 blocks; where more tiles
// than clusters fit at once, each cluster walks several. The weights
// stream in their [taps][C][2C] layout through a 3-stage cp.async ring
// behind a block barrier per stage, each stage (128 input rows x the
// pass's columns) serving all R rows of the block. What bounds it there:
// the per-stage barriers and the weight reads from L2.

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

// ---- the narrow path: mma.sync over tiles of R frames ----
// Warp grid WM x WN; MT m16 tiles and, in each half (gate / filter,
// residual / skip), NG n8 tiles per warp; R = 16 * MT * WM frames a tile;
// KC weight rows (input channels) per ring stage, NS ring stages; CL
// blocks per cluster. At C = 256 chosen by timing variants on an H100 (K1
// alone, L = 20; the probe script was not kept): at B=4, T=256, 16-frame
// tiles over clusters of two beat whole tiles on one block and 32-frame
// tiles over clusters of four. Other widths keep the warps' share of a pass
// (NG = 2 n8 tiles a half) and give a pass GP = WN * 16 gate channels, the
// most that divides a block's share of C: 128 (C % 128 == 0: 16 frames,
// split over a cluster of two where C % 256 == 0), 64 (C % 64 == 0: 32
// frames), 32 (else: 64 frames); KC 64 (32 where C % 64 != 0) keeps the
// ring at C = 384 and 512 beside the window in shared memory.
template <int C>
struct Cfg {
  static constexpr int WN = C % 128 == 0 ? 8 : C % 64 == 0 ? 4 : 2;
  static constexpr int WM = 8 / WN, MT = 1, NG = 2, NS = 3;
  static constexpr int CL = C % 256 == 0 ? 2 : 1;
  static constexpr int KC = C == 256 ? 128 : C % 64 == 0 ? 64 : 32;
};

// CL blocks of a cluster share one tile of frames and split its channels:
// block r owns gate (and residual) channels [r*C/CL, (r+1)*C/CL)
template <int C>
struct Tile {
  static constexpr int WM = Cfg<C>::WM, WN = Cfg<C>::WN, MT = Cfg<C>::MT, NG = Cfg<C>::NG;
  static constexpr int KC = Cfg<C>::KC, NS = Cfg<C>::NS, CL = Cfg<C>::CL;
  static constexpr int R = 16 * MT * WM;  // frames a tile
  static_assert(WM * WN * 32 == kThreads, "warp grid");
  static constexpr int GP = WN * NG * 8;  // gate channels per pass
  static_assert(NG % 2 == 0, "n8 tiles come in pairs");
  static_assert((C / CL) % GP == 0 && C % KC == 0 && KC % 16 == 0, "passes and stages");
  static constexpr int LDB = 2 * GP + 8;  // ring row stride (elements)
  static constexpr int TILE = KC * LDB;
};

// ring stage <- rows [kc, kc + KC) of tap q of W [taps][C][2C]: columns
// [col0, col0 + GP) and [C + col0, C + col0 + GP)
template <int C>
__device__ __forceinline__ void load_tile(bf16* slot, const bf16* __restrict__ W, int t,
                                          int col0) {
  using P = Tile<C>;
  constexpr int KT = C / P::KC;
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
// here ran slower on an H100.)
template <int C>
__device__ __forceinline__ void gemm(float (&acc)[Cfg<C>::MT][2 * Cfg<C>::NG][4],
                                     const bf16* a_base, int lda, int a_tap_step, int taps,
                                     const bf16* __restrict__ W, int col0, bf16* ring) {
  using P = Tile<C>;
  constexpr int NG = P::NG;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / P::WN, wn = warp % P::WN;
  constexpr int KT = C / P::KC;
  const int ntiles = taps * KT;
  const bf16* arow[P::MT];
#pragma unroll
  for (int mt = 0; mt < P::MT; ++mt)
    arow[mt] = a_base + ((wm * P::MT + mt) * 16 + (lane & 15)) * lda + (lane >> 4) * 8;
  const int bcol = ((lane & 7) + ((lane >> 3) & 1) * 8) * P::LDB + wn * NG * 8 + (lane >> 4) * 8;
#pragma unroll
  for (int s = 0; s < P::NS - 1; ++s) {
    if (s < ntiles) load_tile<C>(ring + s * P::TILE, W, s, col0);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<P::NS - 2>();
    __syncthreads();  // tile i landed for every thread; tile i - 1's slot is free
    const int nx = i + P::NS - 1;
    if (nx < ntiles) load_tile<C>(ring + (nx % P::NS) * P::TILE, W, nx, col0);
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

template <int C>
__global__ void __launch_bounds__(kThreads, 1) residual_stack_bf16_kernel(
    const bf16* x0, const bf16* __restrict__ cond, const bf16* __restrict__ step,
    const bf16* __restrict__ wd, const float* __restrict__ bd, const bf16* __restrict__ wo,
    const float* __restrict__ bo, bf16* xbuf, float* skip, int B, int T, int L, int dmax,
    Dilations dil, int write_last) {
  using P = Tile<C>;
  constexpr int NG = P::NG, R = P::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int lda = C + 8;  // ldmatrix rows hit distinct banks
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [R + 2*dmax][lda]: a, masked
  bf16* sG = sA + (size_t)(R + 2 * dmax) * lda;   // [R][lda]: gate
  bf16* ring = sG + (size_t)R * lda;               // [NS][KC][LDB]: weights
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / P::WN, wn = warp % P::WN;
  constexpr int C2 = 2 * C;
  const int tiles_per_seq = (T + R - 1) / R;
  const int n_tiles = B * tiles_per_seq;
  // the (CL, 1, 1) cluster of this block, and its share of the channels
  const int rank = (int)(blockIdx.x % P::CL), n_clusters = (int)(gridDim.x / P::CL);
  const int c_lo = rank * (C / P::CL), c_hi = c_lo + C / P::CL;
  const int cid = (int)(blockIdx.x / P::CL);
  const size_t btc = (size_t)B * T * C;

  for (int l = 0; l < L; ++l) {
    const int d = dil.d[l];
    // the state after layer l is stored for layer l + 1, and after the last
    // layer too in the write-last mode (a pipeline stage hands it on)
    const bool keep_x = l + 1 < L || write_last;
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
      constexpr int C8 = C / 8;
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
        gemm<C>(acc, sA + (size_t)(dmax - d) * lda, lda, d * lda, 3, wdl, col0, ring);
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
        gemm<C>(acc, sG, lda, 0, 1, wol, col0, ring);
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
              xm[h][j] = keep_x ? *reinterpret_cast<const uint32_t*>(src + idx + j * 8) : 0u;
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
              if (keep_x) {
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

template <int C>
cudaError_t launch(const bf16* x0, const bf16* cond, const bf16* step, const bf16* wd,
                   const float* bd, const bf16* wo, const float* bo, bf16* xbuf, float* skip,
                   int B, int T, int L, int dmax, const Dilations& dil, int write_last,
                   int sms, cudaStream_t stream) {
  constexpr int CL = Tile<C>::CL, R = Tile<C>::R;
  const size_t smem =
      ((size_t)(2 * R + 2 * dmax) * (C + 8) + (size_t)Tile<C>::NS * Tile<C>::TILE) * sizeof(bf16);
  auto kern = residual_stack_bf16_kernel<C>;
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
  err = cudaLaunchKernelEx(&cfg, kern, x0, cond, step, wd, bd, wo, bo, xbuf, skip, B, T, L,
                           dmax, dil, write_last);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- the wide path: wgmma over 128-frame tiles, weights by bulk copy ----
namespace wide {

constexpr int R = 128;  // frames a tile up to C = 256, the tiles kWideTiles counts

// The constants of one width (C % 64 == 0; the numbers in the comments are
// C = 256's). Above C = 256 a 128-frame tile's window and gate buffer do
// not fit beside the ring (at C = 512, 150 KB and 131 KB): a tile is 64
// frames there, one consumer warpgroup.
template <int C_>
struct W {
  static constexpr int C = C_;
  static_assert(C % 64 == 0, "the wide path takes C % 64 == 0");
  static constexpr int R = C <= 256 ? wide::R : wide::R / 2;  // frames a tile, 64 a warpgroup
  static constexpr int LDA = C + 8;              // row stride: ldmatrix rows hit distinct banks
  static constexpr int NP = 2 * C / 128;         // passes a GEMM: 4
  static constexpr int kKT = C / 64;             // stages a tap: 4
  static constexpr int kConvStages = 3 * kKT;    // a pass of the dilated conv: 12
  static constexpr int kOutStages = kKT;         // a pass of the 1x1: 4
  static constexpr int kLayerStages = NP * (kConvStages + kOutStages);  // 64, the packed order
  static constexpr int kConsumers = 2 * R;       // a warpgroup per 64 rows: two
  static constexpr int kThreads = kConsumers + 32;  // and the producer warp
};
constexpr int KC = 64;                  // K rows a ring stage, four k16 steps
constexpr int N = 128;                  // columns a pass: 64 channels and their partners
constexpr int NS = 5;                   // ring stages
constexpr int kStageElems = KC * N;     // 8192
constexpr uint32_t kStageBytes = kStageElems * sizeof(bf16);  // 16 KB, one bulk copy
constexpr int kConsumerBar = 1;          // named barrier of the consumer threads
constexpr uint32_t kLbo = 128, kSbo = KC * 16;  // core-matrix steps along K and N, bytes

// the dynamic shared memory of the wide path: ring, barriers, window, gate
template <int C>
__host__ __device__ constexpr size_t smem_bytes(int dmax) {
  return (size_t)NS * kStageBytes + 2 * NS * sizeof(uint64_t) +
         (size_t)(2 * W<C>::R + 2 * dmax) * W<C>::LDA * sizeof(bf16);
}

// a ring position: the slot of the next stage and the parity of its phase
struct Ring {
  uint32_t slot = 0, phase = 0;
  __device__ __forceinline__ void advance() {
    if (++slot == NS) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The consumer side of `nst` ring stages from global stage jc on: acc <-
// A @ B, A's rows from ldmatrix at `arow` (this lane's row and column;
// stage s reads tap s / kKT at (s / kKT) * tap_step elements on, columns
// (s % kKT) * KC on). Keeps the products of one stage in flight while the
// next stage's A is loaded; releases each slot (lane 0 of every warp) once
// the wgmma_wait that retires its products has passed.
template <int C, int NST>
__device__ __forceinline__ void consume(float (&acc)[N / 2], Ring& rc, const bf16* arow,
                                        int tap_step, const bf16* ring, uint64_t* full,
                                        uint64_t* empty, int lane) {
  constexpr int kKT = W<C>::kKT;
  constexpr int KS = KC / 16;  // k16 steps a stage
  uint32_t a[2][KS][4];        // [A buffer][k16 step][fragment]
  auto load_a = [&](uint32_t(&dst)[KS][4], int s) {
    const bf16* p = arow + (s / kKT) * tap_step + (s % kKT) * KC;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldmatrix_a(dst[ks], p + 16 * ks);
  };
  load_a(a[0], 0);
  uint32_t prev = 0;  // the slot of the stage before
#pragma unroll 1
  for (int s = 0; s < NST; s += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (NST % 2 != 0 && s + h >= NST) break;  // an odd count's last pair has one stage
      mbar_wait(full + rc.slot, rc.phase);
      const bf16* tb = ring + rc.slot * kStageElems;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)  // the pass's first product replaces the sums
        wgmma_rs<N>(acc, a[h][ks], smem_desc(tb + 128 * ks, kLbo, kSbo), s + h + ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (s + h > 0 && lane == 0) mbar_arrive(empty + prev);
      prev = rc.slot;
      rc.advance();
      if (s + h + 1 < NST) load_a(a[h ^ 1], s + h + 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < N / 2; ++e) reg_fence(acc[e]);
  if (lane == 0) mbar_arrive(empty + prev);
}

// The producer warp's share of layer l: the bulk copies of the layer's
// stages not issued yet, then (before the grid barrier) the next layer's
// first NS, whose slots the consumers free within this layer. jp is the
// next global stage to issue; per_layer the stages of a layer of this
// block (its tiles x kLayerStages).
template <int C>
__device__ __forceinline__ void produce(uint32_t& jp, Ring& rp, int l, int L, uint32_t per_layer,
                                        const bf16* __restrict__ wpack, bf16* ring,
                                        uint64_t* full, uint64_t* empty, int lane) {
  constexpr int kLayerStages = W<C>::kLayerStages;
  const uint32_t total = per_layer * (uint32_t)L;
  uint32_t until = per_layer * (uint32_t)(l + 1) + (l + 1 < L ? NS : 0);
  if (until > total) until = total;
  if (lane == 0) {
    for (; jp < until; ++jp) {
      // stage jp - NS, the slot's last, released: the phase before this one's
      if (jp >= NS) mbar_wait(empty + rp.slot, rp.phase ^ 1);
      mbar_arrive_expect_tx(full + rp.slot, kStageBytes);
      const uint32_t layer = jp / per_layer, idx = (jp - layer * per_layer) % kLayerStages;
      const bf16* src = wpack + ((size_t)layer * kLayerStages + idx) * kStageElems;
      bulk_copy_g2s(ring + rp.slot * kStageElems, src, kStageBytes, full + rp.slot);
      rp.advance();
    }
    if (l + 1 == L) {  // return only once the consumers are done with every slot
      for (uint32_t j = total > NS ? total - NS : 0; j < total; ++j)
        mbar_wait(empty + j % NS, (j / NS) & 1);
    }
  }
  __syncwarp();
}

// one block a tile of R frames; blocks walk the tiles in strides of the grid
template <int C>
__global__ void __launch_bounds__(W<C>::kThreads, 1) residual_stack_bf16_wgmma_kernel(
    const bf16* x0, const bf16* __restrict__ cond, const bf16* __restrict__ step,
    const bf16* __restrict__ wpack, const float* __restrict__ bd, const float* __restrict__ bo,
    bf16* xbuf, float* skip, int B, int T, int L, int dmax, Dilations dil, int write_last) {
  using P = W<C>;
  constexpr int R = P::R, LDA = P::LDA, NP = P::NP, kConsumers = P::kConsumers;
  constexpr int kConvStages = P::kConvStages, kOutStages = P::kOutStages;
  constexpr int kLayerStages = P::kLayerStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [NS][kStageElems]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (size_t)NS * kStageBytes);
  uint64_t* empty = full + NS;
  bf16* sA = reinterpret_cast<bf16*>(empty + NS);  // [R + 2*dmax][LDA]: a, masked
  bf16* sG = sA + (size_t)(R + 2 * dmax) * LDA;    // [R][LDA]: gate
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool producer = warp == kConsumers / 32;
  const int wg = warp >> 2, wq = warp & 3;  // consumer warpgroup, warp in it
  constexpr int C2 = 2 * C;
  const int tiles_per_seq = (T + R - 1) / R;
  const int n_tiles = B * tiles_per_seq;
  const int n_blocks = (int)gridDim.x;
  const uint32_t my_tiles = (uint32_t)((n_tiles - (int)blockIdx.x + n_blocks - 1) / n_blocks);
  const uint32_t per_layer = my_tiles * kLayerStages;
  const size_t btc = (size_t)B * T * C;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();  // the barriers exist before any copy reaches them
  uint32_t jp = 0;  // the producer's next stage to issue
  Ring rp, rc;      // the producer's and the consumers' ring positions
  // this lane's rows of the tile (and + 8), and first column of a pair
  const int rl = wg * 64 + wq * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  for (int l = 0; l < L; ++l) {
    if (producer) {
      produce<C>(jp, rp, l, L, per_layer, wpack, ring, full, empty, lane);
    } else {
      const int d = dil.d[l];
      const bool keep_x = l + 1 < L || write_last;
      // x is written during the launch: plain loads, never the read-only path
      const bf16* src = (l == 0) ? x0 : xbuf + (size_t)((l - 1) & 1) * btc;
      bf16* dst = xbuf + (size_t)(l & 1) * btc;
      const bf16* condl = cond + (size_t)l * B * T * C2;
      const float* bdl = bd + (size_t)l * C2;
      const float* bol = bo + (size_t)l * C2;
      for (int tile = blockIdx.x; tile < n_tiles; tile += n_blocks) {
        const int b = tile / tiles_per_seq;
        const int t0 = (tile % tiles_per_seq) * R;
        const bf16* stepl = step + ((size_t)l * B + b) * C;
        named_bar_sync(kConsumerBar, kConsumers);  // both warpgroups are done with the window
        // window rows dmax - d + i hold frame t0 - d + i: x by cp.async, then step added
        constexpr int C8 = C / 8;
        for (int e = tid; e < (R + 2 * d) * C8; e += kConsumers) {
          const int i = e / C8, c = (e % C8) * 8;
          const int t = t0 - d + i;
          bf16* row = sA + (size_t)(dmax - d + i) * LDA + c;
          if (t >= 0 && t < T) {
            cp_async16(row, src + ((size_t)b * T + t) * C + c);
          } else {
            *reinterpret_cast<uint4*>(row) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        named_bar_sync(kConsumerBar, kConsumers);
        for (int e = tid; e < (R + 2 * d) * C8; e += kConsumers) {
          const int i = e / C8, c = (e % C8) * 8;
          const int t = t0 - d + i;
          if (t < 0 || t >= T) continue;
          uint4* row = reinterpret_cast<uint4*>(sA + (size_t)(dmax - d + i) * LDA + c);
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
        named_bar_sync(kConsumerBar, kConsumers);

        float acc[N / 2];
        // the dilated conv, NP passes of 64 gate channels (and their filters)
        const bf16* arow_a =
            sA + (size_t)(dmax - d + wg * 64 + wq * 16 + (lane & 15)) * LDA + (lane >> 4) * 8;
        for (int p = 0; p < NP; ++p) {
          consume<C, kConvStages>(acc, rc, arow_a, d * LDA, ring, full, empty, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rl + 8 * h;
            const int t = t0 + r;
            const bool valid = t < T;
            const bf16* cr = condl + ((size_t)b * T + (valid ? t : 0)) * C2 + p * (N / 2) + cq;
#pragma unroll
            for (int i0 = 0; i0 < N / 16; i0 += 4) {
              // four channel groups' cond values first, then their gates
              uint32_t cgv[4], cfv[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                cgv[i] = *reinterpret_cast<const uint32_t*>(cr + (i0 + i) * 8);
                cfv[i] = *reinterpret_cast<const uint32_t*>(cr + C + (i0 + i) * 8);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int ii = i0 + i;
                const int ch = p * (N / 2) + ii * 8 + cq;
                float g0 = 0.f, g1 = 0.f;
                if (valid) {
                  const float2 bg = __ldg(reinterpret_cast<const float2*>(bdl + ch));
                  const float2 bf = __ldg(reinterpret_cast<const float2*>(bdl + C + ch));
                  const float2 cg2 = unpack_bf16x2(cgv[i]), cf2 = unpack_bf16x2(cfv[i]);
                  const float yg0 = acc[8 * ii + 2 * h] + bg.x + cg2.x;
                  const float yg1 = acc[8 * ii + 2 * h + 1] + bg.y + cg2.y;
                  const float yf0 = acc[8 * ii + 4 + 2 * h] + bf.x + cf2.x;
                  const float yf1 = acc[8 * ii + 4 + 2 * h + 1] + bf.y + cf2.y;
                  g0 = tanhf(yf0) / (1.f + expf(-yg0));
                  g1 = tanhf(yf1) / (1.f + expf(-yg1));
                }
                *reinterpret_cast<uint32_t*>(sG + (size_t)r * LDA + ch) = pack_bf16x2(g0, g1);
              }
            }
          }
        }
        __syncwarp();  // a warp's 1x1 reads back the gate rows it wrote
        // the 1x1, NP passes of 64 residual channels (and their skip channels)
        const bf16* arow_g =
            sG + (size_t)(wg * 64 + wq * 16 + (lane & 15)) * LDA + (lane >> 4) * 8;
        for (int p = 0; p < NP; ++p) {
          consume<C, kOutStages>(acc, rc, arow_g, 0, ring, full, empty, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + rl + 8 * h;
            if (t >= T) continue;
            const size_t idx = ((size_t)b * T + t) * C + p * (N / 2) + cq;
            // the row's x and skip values first, then the stores
            uint32_t xm[N / 16];
            float2 sk[N / 16];
#pragma unroll
            for (int i = 0; i < N / 16; ++i) {
              xm[i] = keep_x ? *reinterpret_cast<const uint32_t*>(src + idx + i * 8) : 0u;
              sk[i] = l > 0 ? *reinterpret_cast<const float2*>(skip + idx + i * 8)
                            : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int i = 0; i < N / 16; ++i) {
              const int ch = p * (N / 2) + i * 8 + cq;
              const size_t at = idx + i * 8;
              const float2 br = __ldg(reinterpret_cast<const float2*>(bol + ch));
              const float2 bs = __ldg(reinterpret_cast<const float2*>(bol + C + ch));
              const float zr0 = acc[8 * i + 2 * h] + br.x;
              const float zr1 = acc[8 * i + 2 * h + 1] + br.y;
              const float zs0 = acc[8 * i + 4 + 2 * h] + bs.x;
              const float zs1 = acc[8 * i + 4 + 2 * h + 1] + bs.y;
              if (keep_x) {
                const float2 x2 = unpack_bf16x2(xm[i]);
                *reinterpret_cast<uint32_t*>(dst + at) =
                    pack_bf16x2((x2.x + zr0) * kRsqrt2, (x2.y + zr1) * kRsqrt2);
              }
              *reinterpret_cast<float2*>(skip + at) = make_float2(sk[i].x + zs0, sk[i].y + zs1);
            }
          }
        }
      }
    }
    if (l + 1 < L) grid.sync();  // layer l+1 reads neighbours' frames of layer l
  }
}

template <int C>
cudaError_t launch(const bf16* x0, const bf16* cond, const bf16* step, const bf16* wpack,
                   const float* bd, const float* bo, bf16* xbuf, float* skip, int B, int T,
                   int L, int dmax, const Dilations& dil, int write_last, int sms,
                   cudaStream_t stream) {
  constexpr int R = W<C>::R, kThreads = W<C>::kThreads;
  const size_t smem = smem_bytes<C>(dmax);
  auto kern = residual_stack_bf16_wgmma_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = B * ((T + R - 1) / R);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // every block resident: grid.sync() is safe
  attr[0].val.cooperative = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;  // blocks that fit on the card at once
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  resident *= sms;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(n_tiles < resident ? n_tiles : resident);
  err = cudaLaunchKernelEx(&cfg, kern, x0, cond, step, wpack, bd, bo, xbuf, skip, B, T, L, dmax,
                           dil, write_last);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wide

// the wide path from this many 128-frame tiles (on an H100: 1.33-1.49 ms
// against the narrow path's 1.86-1.90 at 32, B=4, T=1024; 1.27-1.49
// against 0.43-0.48 at 8, B=4, T=256; C = 256, PERF.md); ops/diffnet_stack.py
// `WIDE_TILES` is the same number (the wrapper packs the weights only then)
constexpr int kWideTiles = 32;

#ifndef KERNEL_WIDTH
#error "build with -DKERNEL_WIDTH=<C> (ops/_build.py WIDTHS lists the widths)"
#endif
constexpr int kC = KERNEL_WIDTH;  // this library's width
static_assert(kC % 32 == 0 && kC >= 32 && kC <= 512, "K1 takes C % 32 == 0, 32 <= C <= 512");

// the wide path where C % 64 == 0, from kWideTiles 128-frame tiles on and
// where its window fits beside the ring; else the narrow path (the rule of
// ops/diffnet_stack.py `uses_wide_path`, which packs the weights only then)
template <int C>
cudaError_t dispatch(const bf16* x0, const bf16* cond, const bf16* step, const bf16* wd,
                     const float* bd, const bf16* wo, const float* bo, const bf16* wpack,
                     bf16* xbuf, float* skip, int B, int T, int L, int dmax, const Dilations& dil,
                     int write_last, int sms, int smem_max, cudaStream_t s) {
  if constexpr (C % 64 == 0) {
    if ((long long)B * ((T + wide::R - 1) / wide::R) >= kWideTiles &&
        wide::smem_bytes<C>(dmax) <= (size_t)smem_max) {
      if (wpack == nullptr) return cudaErrorInvalidValue;
      return wide::launch<C>(x0, cond, step, wpack, bd, bo, xbuf, skip, B, T, L, dmax, dil,
                              write_last, sms, s);
    }
  }
  return launch<C>(x0, cond, step, wd, bd, wo, bo, xbuf, skip, B, T, L, dmax, dil, write_last,
                    sms, s);
}

}  // namespace

extern "C" {

// Both entry points take x0 [B,T,C] bf16 (C = KERNEL_WIDTH, the width
// this library is built for), cond [L,B,T,2C] bf16, step [L,B,C] bf16, wd
// [L,3,C,2C] bf16, bd [L,2C] fp32, wo [L,C,2C] bf16, bo [L,2C] fp32, wpack
// [L, 4 (C/64)^2, 8192] bf16 (wd and wo in the wide path's ring order,
// ops/diffnet_stack.py `pack_weights_bf16`), all contiguous on `device`;
// dilations is a host array of L ints; xbuf [2,B,T,C] bf16 scratch; skip
// [B,T,C] fp32 output. With write_last set, the state after the last layer
// is stored too, in xbuf[(L - 1) % 2] (a pipeline stage's output); else it
// is never formed. The narrow path reads wd and wo, the wide one wpack
// (which may be null where the narrow path is taken: ops/diffnet_stack.py
// `uses_wide_path`). It returns a cudaError_t (0 on success).
int diffnet_residual_stack_bf16(const void* x0, const void* cond, const void* step,
                                const void* wd, const float* bd, const void* wo, const float* bo,
                                const void* wpack, const int* dilations, void* xbuf, float* skip,
                                int B, int T, int C, int L, int write_last, int device,
                                void* stream) {
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
  int sms = 0, smem_max = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch<kC>(static_cast<const bf16*>(x0), static_cast<const bf16*>(cond),
                       static_cast<const bf16*>(step), static_cast<const bf16*>(wd), bd,
                       static_cast<const bf16*>(wo), bo, static_cast<const bf16*>(wpack),
                       static_cast<bf16*>(xbuf), skip, B, T, L, dmax, dil, write_last, sms,
                       smem_max, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
