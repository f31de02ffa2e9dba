// K1: the DiffNet residual stack, all L layers in one cooperative launch.
//
// Replaces bisinger_tpu/ops/diffnet_pallas.py:fused_residual_stack (body
// _stack_kernel). Per layer l with dilation d = dil[l], for every frame t:
//   a      = (x + step[l])  zeroed outside [0, T)        (SAME padding)
//   y      = sum_{tau in -1,0,1} a[t + tau*d] @ wd[l][tau+1] + bd[l] + cond[l][t]
//   g      = sigmoid(y[:C]) * tanh(y[C:])
//   z      = g @ wo[l] + bo[l]
//   x      = (x + z[:C]) / sqrt(2);   skip += z[C:]
// Output: skip [B, T, C]; the caller scales it by 1/sqrt(L).
//
// Types: fp32 operands, fp32 accumulation (the TPU kernel feeds bf16
// operands; fp32 here keeps the kernel within float rounding of the plain
// version and of the JAX XLA path).
//
// Design. One sequence's hidden state (T x C fp32, 1 MB at T=1024, C=256)
// does not fit one SM's 227 KB of shared memory, and a layer's dilated
// taps need neighbouring frames of the previous layer. Rather than
// recompute a halo of sum(d) = 75 frames per side over the whole stack
// (several times the useful work at the tile sizes shared memory allows),
// the state goes through device memory between layers (ping-pong buffers,
// L2-resident at the path's sizes) and a grid-wide barrier separates the
// layers. The launch is cooperative, so all blocks are resident and the
// barrier is safe; each block walks tiles of R frames of one sequence.
// A tile's block owns all 2C outputs of both products, so the gate and the
// output projection stay in shared memory: a [(R + 2*dmax), C] window of
// (x + step) and the [R, C] gate. Thread c owns gate channel c (columns c
// and C + c of both products), so no data crosses threads after a product.
//
// Bound. 16*C^2 FLOP per frame per layer (3 taps C->2C, one 1x1 C->2C):
// 21.5 GFLOP per call at B=4, T=256, C=256, L=20, against ~85 MB of
// inputs, so the operations bound it (fp32 CUDA cores, 67 TFLOP/s on an
// H100 SXM). This first version streams the weights from L2 for every tile
// and reaches a fraction of that; wgmma on bf16 tiles is the next step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLayers = 64;
constexpr float kRsqrt2 = 0.70710678118654752f;

struct Dilations {
  int d[kMaxLayers];
};

template <int R>
__global__ void __launch_bounds__(512) residual_stack_kernel(
    const float* x0, const float* __restrict__ cond, const float* __restrict__ step,
    const float* __restrict__ wd, const float* __restrict__ bd, const float* __restrict__ wo,
    const float* __restrict__ bo, float* xbuf, float* skip, int B, int T, int C, int L,
    int dmax, Dilations dil) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                        // [(R + 2*dmax), C]: (x + step), masked
  float* sG = smem + (R + 2 * dmax) * C;   // [R, C]: gate
  cg::grid_group grid = cg::this_grid();
  const int c = threadIdx.x;  // blockDim.x == C
  const int C2 = 2 * C;
  const int tiles_per_seq = (T + R - 1) / R;
  const int n_tiles = B * tiles_per_seq;
  const size_t btc = (size_t)B * T * C;

  for (int l = 0; l < L; ++l) {
    const int d = dil.d[l];
    // x is written during the launch: plain loads, never the read-only path
    const float* src = (l == 0) ? x0 : xbuf + (size_t)((l - 1) & 1) * btc;
    float* dst = xbuf + (size_t)(l & 1) * btc;
    const float* wdl = wd + (size_t)l * 3 * C * C2;
    const float* wol = wo + (size_t)l * C * C2;
    const float* condl = cond + (size_t)l * B * T * C2;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int b = tile / tiles_per_seq;
      const int t0 = (tile % tiles_per_seq) * R;
      const float sv = step[((size_t)l * B + b) * C + c];
      for (int i = 0; i < R + 2 * dmax; ++i) {
        const int t = t0 - dmax + i;
        sA[i * C + c] = (t >= 0 && t < T) ? src[((size_t)b * T + t) * C + c] + sv : 0.f;
      }
      __syncthreads();

      float acc_g[R], acc_f[R];
      const float bg = bd[l * C2 + c], bf = bd[l * C2 + C + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc_g[r] = bg;
        acc_f[r] = bf;
      }
      for (int tap = 0; tap < 3; ++tap) {
        const float* a0 = sA + (dmax + (tap - 1) * d) * C;
        const float* w = wdl + (size_t)tap * C * C2;
        for (int k = 0; k < C; k += 4) {
          float wg[4], wf[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wg[j] = __ldg(w + (size_t)(k + j) * C2 + c);
            wf[j] = __ldg(w + (size_t)(k + j) * C2 + C + c);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(a0 + r * C + k);
            acc_g[r] = fmaf(a.x, wg[0], acc_g[r]);
            acc_g[r] = fmaf(a.y, wg[1], acc_g[r]);
            acc_g[r] = fmaf(a.z, wg[2], acc_g[r]);
            acc_g[r] = fmaf(a.w, wg[3], acc_g[r]);
            acc_f[r] = fmaf(a.x, wf[0], acc_f[r]);
            acc_f[r] = fmaf(a.y, wf[1], acc_f[r]);
            acc_f[r] = fmaf(a.z, wf[2], acc_f[r]);
            acc_f[r] = fmaf(a.w, wf[3], acc_f[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = t0 + r;
        float g = 0.f;
        if (t < T) {
          const float* cr = condl + ((size_t)b * T + t) * C2;
          const float yg = acc_g[r] + cr[c];
          const float yf = acc_f[r] + cr[C + c];
          g = tanhf(yf) / (1.f + expf(-yg));
        }
        sG[r * C + c] = g;
      }
      __syncthreads();

      float acc_r[R], acc_s[R];
      const float br = bo[l * C2 + c], bs = bo[l * C2 + C + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc_r[r] = br;
        acc_s[r] = bs;
      }
      for (int k = 0; k < C; k += 4) {
        float wr[4], ws[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wr[j] = __ldg(wol + (size_t)(k + j) * C2 + c);
          ws[j] = __ldg(wol + (size_t)(k + j) * C2 + C + c);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(sG + r * C + k);
          acc_r[r] = fmaf(a.x, wr[0], acc_r[r]);
          acc_r[r] = fmaf(a.y, wr[1], acc_r[r]);
          acc_r[r] = fmaf(a.z, wr[2], acc_r[r]);
          acc_r[r] = fmaf(a.w, wr[3], acc_r[r]);
          acc_s[r] = fmaf(a.x, ws[0], acc_s[r]);
          acc_s[r] = fmaf(a.y, ws[1], acc_s[r]);
          acc_s[r] = fmaf(a.z, ws[2], acc_s[r]);
          acc_s[r] = fmaf(a.w, ws[3], acc_s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = t0 + r;
        if (t < T) {
          const size_t idx = ((size_t)b * T + t) * C + c;
          if (l + 1 < L) dst[idx] = (src[idx] + acc_r[r]) * kRsqrt2;
          skip[idx] = (l == 0 ? 0.f : skip[idx]) + acc_s[r];
        }
      }
      __syncthreads();  // sA and sG are refilled by the next tile
    }
    if (l + 1 < L) grid.sync();  // layer l+1 reads neighbours' frames of layer l
  }
}

template <int R>
cudaError_t launch(const float* x0, const float* cond, const float* step, const float* wd,
                   const float* bd, const float* wo, const float* bo, float* xbuf,
                   float* skip, int B, int T, int C, int L, int dmax, const Dilations& dil,
                   int sms, cudaStream_t stream) {
  const size_t smem = (size_t)((R + 2 * dmax) * C + R * C) * sizeof(float);
  auto kern = residual_stack_kernel<R>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, C, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_tiles = B * ((T + R - 1) / R);
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  void* args[] = {(void*)&x0, (void*)&cond, (void*)&step, (void*)&wd, (void*)&bd,
                  (void*)&wo, (void*)&bo,   (void*)&xbuf, (void*)&skip, (void*)&B,
                  (void*)&T,  (void*)&C,    (void*)&L,    (void*)&dmax, (void*)&dil};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(C), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x0 [B,T,C], cond [L,B,T,2C], step [L,B,C], wd [L,3,C,2C], bd [L,2C],
// wo [L,C,2C], bo [L,2C], all fp32 contiguous on `device`; dilations is a
// host array of L ints; xbuf [2,B,T,C] scratch; skip [B,T,C] output.
// Returns a cudaError_t (0 on success).
int diffnet_residual_stack(const float* x0, const float* cond, const float* step,
                           const float* wd, const float* bd, const float* wo, const float* bo,
                           const int* dilations, float* xbuf, float* skip, int B, int T, int C,
                           int L, int device, void* stream) {
  if (L < 1 || L > kMaxLayers || C < 32 || C > 512 || C % 32 != 0 || B < 1 || T < 1)
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
  // small problems use 8-frame tiles so that more SMs get work
  const bool wide = (long long)B * ((T + 15) / 16) >= 2LL * sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = wide ? launch<16>(x0, cond, step, wd, bd, wo, bo, xbuf, skip, B, T, C, L, dmax, dil,
                          sms, s)
             : launch<8>(x0, cond, step, wd, bd, wo, bo, xbuf, skip, B, T, C, L, dmax, dil,
                         sms, s);
  return (int)err;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
