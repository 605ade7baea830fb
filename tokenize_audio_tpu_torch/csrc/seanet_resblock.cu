// Fused SEANet residual block + ELU, hand-written for Hopper.
//
// Replaces: tokenize_audio_tpu/ops/pallas/seanet.py, resblock_elu_pallas ->
// _resblock_kernel (the TPU kernel scans time tiles in order and carries
// the last two raw-x columns across grid steps in VMEM scratch).
//
// Computes, for x (B, C, T), per-row valid lengths, w3 (C2, C, 3), b3 (C2),
// w1 (C, C2, 1), b1 (C):
//   h  = elu(conv3(elu(x)) + b3)     causal 3-tap conv, zero before t = 0
//   y  = x + (W1 . h + b1)
//   ye = elu(y masked to 0 at t >= valid[row])
// the MimiResnetBlock plus the stage's following ELU; the strided down-conv
// runs after it in PyTorch.
//
// What bounds it on this card: two channel-mixing products, 3*C*C2 + C*C2
// multiply-adds (4*C^2 flop at C2 = C/2) per time step, against ~8*C bytes
// (x read, ye written) per step: 32 flop/byte at C = 64 and more above,
// past the FP32 ridge (~20 flop/byte) at every stage. So the FP32 CUDA-core
// rate bounds it (the parity mode excludes TF32, so no tensor cores).
//
// What the design does about that: blocks run in parallel and in no order,
// so nothing is carried between them. A block owns one (row, time tile) and
// reads a 2-column left halo of raw x (zero at t < 0). elu(x) for the tile
// and halo, and the intermediate h, stay in shared memory; x is read once
// (plus the halo) and ye written once. Both products run as shared-memory
// tiled GEMMs: weight chunks are staged through shared memory and each
// thread accumulates an RM x RN register tile. The thread layout follows C:
// the block's TY thread rows times RM cover all C/2 output channels of the
// first product in one pass (so each weight chunk is staged once per pass
// and the barriers per multiply-add stay few), and the time tile (TX thread
// columns times RN) narrows as C grows so elu(x) fits in shared memory:
// 256 columns at C <= 64, down to 32 at C = 512. ELU is expm1f.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CK = 8;  // input channels per staged weight chunk

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

template <int TX, int RM, int RN>
__global__ void __launch_bounds__(THREADS, 2)
resblock_kernel(const float* __restrict__ x, const int* __restrict__ valid,
                const float* __restrict__ w3, const float* __restrict__ b3,
                const float* __restrict__ w1, const float* __restrict__ b1,
                float* __restrict__ out, int c, int c2, int t_len) {
  constexpr int TY = THREADS / TX;
  constexpr int TT = TX * RN;  // time columns per block
  constexpr int BM = TY * RM;  // output channels per pass
  constexpr int XS = TT + 2;   // tile + 2-column causal halo
  constexpr int WS1 = CK * 3 + 1;
  constexpr int WS2 = CK + 1;
  static_assert(BM * CK % THREADS == 0, "weight chunks split evenly over the threads");
  extern __shared__ float smem[];
  float* xe = smem;               // c x XS: elu(x)
  float* hs = xe + c * XS;        // c2 x TT: h
  float* ws = hs + c2 * TT;       // BM x WS1 weight chunk

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)b * c * t_len;
  float* ob = out + (size_t)b * c * t_len;
  const int vb = valid[b];

  // LU loads in flight per thread before any is used: the tile load is
  // latency-bound otherwise
  constexpr int LU = 8;
  for (int i0 = tid; i0 < c * XS; i0 += THREADS * LU) {
    float vals[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int i = i0 + u * THREADS, ch = i / XS, t = t0 - 2 + i % XS;
      vals[u] = (i < c * XS && t >= 0 && t < t_len) ? xb[(size_t)ch * t_len + t] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int i = i0 + u * THREADS;
      if (i < c * XS) xe[i] = elu(vals[u]);
    }
  }

  // h = elu(W3 * xe + b3): K = c input channels x 3 taps
  for (int m0 = 0; m0 < c2; m0 += BM) {
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < c; c0 += CK) {
      __syncthreads();  // xe is loaded / the previous chunk's readers are done
#pragma unroll
      for (int u = 0; u < BM * CK * 3 / THREADS; ++u) {
        const int i = tid + u * THREADS, mm = i / (CK * 3), q = i % (CK * 3);
        const int m = m0 + mm, ch = c0 + q / 3;
        ws[mm * WS1 + q] =
            (m < c2 && ch < c) ? w3[((size_t)m * c + c0) * 3 + q] : 0.f;
      }
      __syncthreads();
      const int cmax = min(CK, c - c0);
      for (int cc = 0; cc < cmax; ++cc) {
        const float* xr = xe + (c0 + cc) * XS;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float a[RM], bv[RN];
#pragma unroll
          for (int i = 0; i < RM; ++i) a[i] = ws[(ty + TY * i) * WS1 + cc * 3 + k];
#pragma unroll
          for (int j = 0; j < RN; ++j) bv[j] = xr[tx + TX * j + k];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + ty + TY * i;
      if (m < c2) {
        const float bias = b3[m];
#pragma unroll
        for (int j = 0; j < RN; ++j) hs[m * TT + tx + TX * j] = elu(acc[i][j] + bias);
      }
    }
  }

  // ye = elu(mask(x + (W1 * h + b1))): K = c2 channels
  for (int m0 = 0; m0 < c; m0 += BM) {
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < c2; c0 += CK) {
      __syncthreads();  // hs is complete / the previous chunk's readers are done
#pragma unroll
      for (int u = 0; u < BM * CK / THREADS; ++u) {
        const int i = tid + u * THREADS, mm = i / CK, cc = i % CK;
        const int m = m0 + mm, ch = c0 + cc;
        ws[mm * WS2 + cc] = (m < c && ch < c2) ? w1[(size_t)m * c2 + ch] : 0.f;
      }
      __syncthreads();
      const int cmax = min(CK, c2 - c0);
      for (int cc = 0; cc < cmax; ++cc) {
        const float* hr = hs + (c0 + cc) * TT;
        float a[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = ws[(ty + TY * i) * WS2 + cc];
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = hr[tx + TX * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = m0 + ty + TY * i;
      if (m < c) {
        const float bias = b1[m];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int t = t0 + tx + TX * j;
          if (t < t_len) {
            const float y = xb[(size_t)m * t_len + t] + (acc[i][j] + bias);
            ob[(size_t)m * t_len + t] = elu(t < vb ? y : 0.f);
          }
        }
      }
    }
  }
}

template <int TX, int RM, int RN>
int launch(const float* x, const int* valid, const float* w3, const float* b3,
           const float* w1, const float* b1, float* out, int b, int c, int c2,
           int t_len, cudaStream_t stream) {
  constexpr int TT = TX * RN;
  constexpr int BM = THREADS / TX * RM;
  const size_t smem = sizeof(float) * ((size_t)c * (TT + 2) + (size_t)c2 * TT +
                                       (size_t)BM * (CK * 3 + 1));
  cudaError_t err = cudaFuncSetAttribute(
      resblock_kernel<TX, RM, RN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + TT - 1) / TT, b);
  resblock_kernel<TX, RM, RN><<<grid, THREADS, smem, stream>>>(x, valid, w3, b3, w1, b1,
                                                               out, c, c2, t_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Layout by the width of the first product (c2 = C/2 output channels):
// one pass of BM = (256 / TX) * RM >= c2 channels, time tile TT = TX * RN.
extern "C" int resblock_elu_launch(const float* x, const int* valid, const float* w3,
                                   const float* b3, const float* w1, const float* b1,
                                   float* out, int b, int c, int c2, int t_len,
                                   void* stream) {
  if (b <= 0 || t_len <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c2 <= 32) return launch<16, 2, 16>(x, valid, w3, b3, w1, b1, out, b, c, c2, t_len, s);
  if (c2 <= 64) return launch<16, 4, 8>(x, valid, w3, b3, w1, b1, out, b, c, c2, t_len, s);
  if (c2 <= 128) return launch<8, 4, 8>(x, valid, w3, b3, w1, b1, out, b, c, c2, t_len, s);
  return launch<4, 4, 8>(x, valid, w3, b3, w1, b1, out, b, c, c2, t_len, s);
}
