// Fused SEANet residual block + ELU, hand-written for Hopper.
//
// Replaces: tokenize_audio_tpu/ops/pallas/seanet.py, resblock_elu_pallas ->
// _resblock_kernel (the TPU kernel scans time tiles in order and carries
// the last two raw-x columns across grid steps in VMEM scratch).
//
// Computes, for x (B, C, T), per-row valid lengths, b3 (C2), b1 (C) and the
// conv weights packed once by the wrapper (ops/cuda/seanet.py:pack_weights)
// as w3p (C, 3, ld3) = w3[m, c, k] at [c, k, m] and w1p (C2, ld1) =
// w1[m, c2, 0] at [c2, m], zero-padded to ld3 = ceil4(C2), ld1 = ceil4(C):
//   h  = elu(conv3(elu(x)) + b3)     causal 3-tap conv, zero before t = 0
//   y  = x + (W1 . h + b1)
//   ye = elu(y masked to 0 at t >= valid[row])
// the MimiResnetBlock plus the stage's following ELU; the strided down-conv
// runs after it in PyTorch. ELU is expm1f; all arithmetic is IEEE FP32 on
// the CUDA cores (parity mode excludes TF32, so no tensor cores).
//
// What bounds it on this card: two channel-mixing products, 4*C^2 flop per
// time column against ~8*C bytes of x in and ye out, past the FP32 ridge at
// every stage, so the 67 TFLOP/s FP32 rate. What holds it back, measured at
// the main path's own shapes with builds that drop the ELUs or the FMA
// loops (PERF.md): three parts of similar size that overlap only as far as other warps on the SM have
// other work -- the FMA loops; the ELUs (2.5*C expm1f per column, a long
// dependent chain each, run between barriers); and the rest (the ring's
// loads, the barriers, the epilogues). So warps per SM count for more than
// the register tile's size. At the main path's small batches (a C = 512
// launch has 200 to 13 000 columns) filling 132 SMs at all is the other
// limit, and a launch of one or two time tiles is bound by the latency of
// its serial chunk chain.
//
// What the design does about it:
//  - A K-loop over chunks of CK input channels through a ring of S stages
//    in shared memory, filled with cp.async (16-byte copies where the row
//    allows), so the next chunk loads while this one is multiplied; one
//    __syncthreads per chunk. Each stage holds the elu(x) chunk (CK rows of
//    TT columns plus the 2-column causal halo) and the matching weight
//    chunk; each thread applies ELU to the elements it copied itself once
//    they land, before the barrier, so ELU runs once per element and block.
//    The ring runs on from the first product's chunks into the second's, so
//    W1's first chunks load during the first product's tail.
//  - Register tiles of RM x RN (8 x 4, or 4 x 4 where the cluster splits a
//    tile's rows 4 ways) per thread, as groups of 4 rows and 4 columns, so
//    every shared-memory operand is a 16-byte load (the x row as float2 +
//    float4): per input channel a thread loads its RN + 2 elu(x) values
//    once and reuses them for all three taps. The weights are packed so one
//    thread's output channels are contiguous.
//  - 256 threads per block with registers capped at 128, so two blocks (16
//    warps) share an SM and one block's ELU or barrier phase overlaps the
//    other's FMAs. The first port's 8 x 8 tiles in 128-thread blocks (12
//    warps per SM) took 1.2-1.5x as long at C <= 128 (PERF.md).
//  - h for the tile stays in shared memory and feeds the second product;
//    it never goes to device memory.
//  - At C >= 256 one time tile's output channels are split over a cluster
//    of CL blocks: each block computes C2/CL rows of h from its 1/CL of W3
//    and stores them into every block's h through distributed shared
//    memory; one cluster barrier later each block computes C/CL output
//    rows from the whole h with its 1/CL of W1. So a batch of few columns
//    still spreads over many SMs while each block streams only 1/CL of
//    the weights (each block of a cluster still loads and ELUs the whole
//    x chunk). The variant is chosen from C and the launch's column count
//    (pick(), at the bottom of this file).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expm1f(v);
}

__device__ __forceinline__ float4 elu4(float4 v) {
  return make_float4(elu(v.x), elu(v.y), elu(v.z), elu(v.w));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous global->shared copies; a false predicate writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One kernel variant. Threads TY x TX; a thread owns rows
// ty*4 + g*4*TY + (0..3) (g < RM/4) and columns tx*4 + g*4*TX + (0..3)
// (g < RN/4) of a BM x TT output tile. CL blocks (a cluster) share one time
// tile. CK input channels per chunk, S ring stages.
template <int RM, int RN, int TY, int TX, int CL, int CK, int S>
struct Variant {
  static constexpr int THREADS = TY * TX;
  static constexpr int BM = RM * TY;        // output rows per pass
  static constexpr int TT = RN * TX;        // time columns per tile
  static constexpr int XS = TT + 4;         // x row: index i <-> column t0 - 4 + i
  static constexpr int SLOT = CK * XS + 3 * CK * BM;
  static_assert(RM % 4 == 0 && RN % 4 == 0, "register tiles are groups of 4");
  static_assert(BM % CK == 0 && CK % 4 == 0, "h rows split into whole chunks");
  static_assert(S >= 2, "a ring needs two stages");

  // rows of h, padded so every block of the cluster owns whole passes
  static int c2p(int c2) { return (c2 + CL * BM - 1) / (CL * BM) * (CL * BM); }
  static size_t smem_bytes(int c2) {
    return sizeof(float) * ((size_t)S * SLOT + (size_t)c2p(c2) * TT);
  }
};

// two blocks per SM: at 256 threads, registers are capped at 128
template <int RM, int RN, int TY, int TX, int CL, int CK, int S>
__global__ void __launch_bounds__(TY * TX, 2)
resblock_kernel(const float* __restrict__ x, const int* __restrict__ valid,
                const float* __restrict__ w3p, const float* __restrict__ b3,
                const float* __restrict__ w1p, const float* __restrict__ b1,
                float* __restrict__ out, int c, int c2, int t_len, int ld3, int ld1,
                int vec) {
  using V = Variant<RM, RN, TY, TX, CL, CK, S>;
  constexpr int THREADS = V::THREADS, BM = V::BM, TT = V::TT, XS = V::XS, SLOT = V::SLOT;
  constexpr int GR = RM / 4, GC = RN / 4;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;               // S x SLOT: [CK x XS elu(x) | 3*CK x BM weights]
  float* h_s = smem + S * SLOT;     // c2p x TT

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int rank = CL > 1 ? (int)blockIdx.x % CL : 0;
  const int t0 = (blockIdx.x / CL) * TT;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * c * t_len;
  float* ob = out + (size_t)b * c * t_len;
  const int vb = valid[b];

  const int c2p = (c2 + CL * BM - 1) / (CL * BM) * (CL * BM);
  const int m1 = c2p / CL;                               // h rows per block
  const int m2 = ((c + CL - 1) / CL + BM - 1) / BM * BM;  // output rows per block
  const int n1 = (c + CK - 1) / CK, p1 = m1 / BM;        // first product: chunks x passes
  const int n2 = c2p / CK, p2 = m2 / BM;                 // second product
  const int n_first = n1 * p1, n_all = n_first + n2 * p2;

  if constexpr (CL > 1) cluster_arrive_relaxed();  // paired with the wait before h is shared

  // --- chunk q -> ring slot q % S
  auto load_chunk = [&](int q) {
    float* xs = ring + (q % S) * SLOT;
    float* ws = xs + CK * XS;
    if (q < n_first) {
      const int pass = q / n1, c0 = (q % n1) * CK;
      const int mb = rank * m1 + pass * BM;
      for (int i = tid; i < CK * (TT / 4); i += THREADS) {
        const int cc = i / (TT / 4), t = t0 + (i % (TT / 4)) * 4, ch = c0 + cc;
        float* dst = xs + cc * XS + 4 + (t - t0);
        const float* src = xb + (size_t)ch * t_len + t;
        if (vec) {
          const bool ok = ch < c && t < t_len;
          cp_async16(dst, ok ? src : xb, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = ch < c && t + e < t_len;
            cp_async4(dst + e, ok ? src + e : xb, ok);
          }
        }
      }
      for (int i = tid; i < CK * 2; i += THREADS) {  // causal halo: t0 - 2, t0 - 1
        const int cc = i / 2, t = t0 - 2 + i % 2, ch = c0 + cc;
        const bool ok = ch < c && t >= 0;
        cp_async4(xs + cc * XS + 2 + i % 2, ok ? xb + (size_t)ch * t_len + t : xb, ok);
      }
      for (int i = tid; i < 3 * CK * (BM / 4); i += THREADS) {
        const int r = i / (BM / 4), m = mb + (i % (BM / 4)) * 4, ch = c0 + r / 3;
        const bool ok = ch < c && m < ld3;
        cp_async16(ws + r * BM + (m - mb), ok ? w3p + ((size_t)c0 * 3 + r) * ld3 + m : w3p, ok);
      }
    } else {
      const int pass = (q - n_first) / n2, c0 = ((q - n_first) % n2) * CK;
      const int mb = rank * m2 + pass * BM;
      for (int i = tid; i < CK * (BM / 4); i += THREADS) {
        const int cc = i / (BM / 4), m = mb + (i % (BM / 4)) * 4;
        const bool ok = c0 + cc < c2 && m < ld1;
        cp_async16(ws + cc * BM + (m - mb), ok ? w1p + (size_t)(c0 + cc) * ld1 + m : w1p, ok);
      }
    }
  };
  // ELU in place on the elu(x) elements this thread copied (visible to it
  // after its own wait_group)
  auto elu_own = [&](int q) {
    float* xs = ring + (q % S) * SLOT;
    for (int i = tid; i < CK * (TT / 4); i += THREADS) {
      float4* p = reinterpret_cast<float4*>(xs + (i / (TT / 4)) * XS + 4 + (i % (TT / 4)) * 4);
      *p = elu4(*p);
    }
    for (int i = tid; i < CK * 2; i += THREADS) {
      float* p = xs + (i / 2) * XS + 2 + i % 2;
      *p = elu(*p);
    }
  };

  float acc[RM][RN];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  };
  zero();

#pragma unroll
  for (int q = 0; q < S - 1; ++q) {
    if (q < n_all) load_chunk(q);
    cp_async_commit();
  }

  for (int q = 0; q < n_all; ++q) {
    cp_async_wait<S - 2>();
    if (q < n_first) elu_own(q);
    if constexpr (CL > 1) {
      if (q == n_first) {  // every block's h rows are in every block's h_s
        cluster_arrive();
        cluster_wait();
      } else {
        __syncthreads();
      }
    } else {
      __syncthreads();  // chunk q visible; every thread is done with chunk q - 1
    }
    if (q + S - 1 < n_all) load_chunk(q + S - 1);  // into the slot of chunk q - 1
    cp_async_commit();

    const float* xs = ring + (q % S) * SLOT;
    const float* ws = xs + CK * XS;
    if (q < n_first) {
      // h += W3[:, c0:c0+CK, k] . elu(x)[c0:c0+CK, t - 2 + k]
      for (int cc = 0; cc < CK; ++cc) {
        float v[GC][6];
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float* p = xs + cc * XS + tx * 4 + g * 4 * TX + 2;
          const float2 lo = *reinterpret_cast<const float2*>(p);
          const float4 hi = *reinterpret_cast<const float4*>(p + 2);
          v[g][0] = lo.x; v[g][1] = lo.y;
          v[g][2] = hi.x; v[g][3] = hi.y; v[g][4] = hi.z; v[g][5] = hi.w;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float w[RM];
#pragma unroll
          for (int g = 0; g < GR; ++g) {
            const float4 a =
                *reinterpret_cast<const float4*>(ws + (cc * 3 + k) * BM + ty * 4 + g * 4 * TY);
            w[g * 4] = a.x; w[g * 4 + 1] = a.y; w[g * 4 + 2] = a.z; w[g * 4 + 3] = a.w;
          }
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int g = 0; g < GC; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][g * 4 + e] = fmaf(w[i], v[g][e + k], acc[i][g * 4 + e]);
        }
      }
    } else {
      // y += W1[:, c0:c0+CK] . h[c0:c0+CK, t]
      const float* hs = h_s + (size_t)(((q - n_first) % n2) * CK) * TT;
#pragma unroll 4
      for (int cc = 0; cc < CK; ++cc) {
        float hv[RN], w[RM];
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4 a = *reinterpret_cast<const float4*>(hs + cc * TT + tx * 4 + g * 4 * TX);
          hv[g * 4] = a.x; hv[g * 4 + 1] = a.y; hv[g * 4 + 2] = a.z; hv[g * 4 + 3] = a.w;
        }
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          const float4 a = *reinterpret_cast<const float4*>(ws + cc * BM + ty * 4 + g * 4 * TY);
          w[g * 4] = a.x; w[g * 4 + 1] = a.y; w[g * 4 + 2] = a.z; w[g * 4 + 3] = a.w;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(w[i], hv[j], acc[i][j]);
      }
    }

    if (q < n_first) {
      if ((q + 1) % n1 != 0) continue;
      // end of a pass of the first product: h = elu(acc + b3), rows >= c2
      // come out 0 (zero weights and bias), the padding the second product
      // reads as whole chunks
      const int mb = rank * m1 + (q / n1) * BM;
      if constexpr (CL > 1) {
        if (q + 1 == n1) cluster_wait();  // every block of the cluster has started
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = mb + (i / 4) * 4 * TY + ty * 4 + i % 4;
        const float bias = m < c2 ? b3[m] : 0.f;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4 hv = elu4(make_float4(acc[i][g * 4] + bias, acc[i][g * 4 + 1] + bias,
                                             acc[i][g * 4 + 2] + bias, acc[i][g * 4 + 3] + bias));
          const int col = tx * 4 + g * 4 * TX;
          if constexpr (CL > 1) {
            cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
            for (int r = 0; r < CL; ++r)
              *reinterpret_cast<float4*>(cluster.map_shared_rank(h_s, r) + (size_t)m * TT + col) = hv;
          } else {
            *reinterpret_cast<float4*>(h_s + (size_t)m * TT + col) = hv;
          }
        }
      }
      zero();
    } else {
      if ((q - n_first + 1) % n2 != 0) continue;
      // end of a pass of the second product: ye = elu(mask(x + (acc + b1)))
      const int mb = rank * m2 + ((q - n_first) / n2) * BM;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = mb + (i / 4) * 4 * TY + ty * 4 + i % 4;
        if (m >= c) continue;
        const float bias = b1[m];
        const float* xr = xb + (size_t)m * t_len;
        float* orow = ob + (size_t)m * t_len;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const int t = t0 + tx * 4 + g * 4 * TX;
          if (vec) {
            if (t >= t_len) continue;
            const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + t));
            float4 y;
            y.x = elu(t < vb ? xv.x + (acc[i][g * 4] + bias) : 0.f);
            y.y = elu(t + 1 < vb ? xv.y + (acc[i][g * 4 + 1] + bias) : 0.f);
            y.z = elu(t + 2 < vb ? xv.z + (acc[i][g * 4 + 2] + bias) : 0.f);
            y.w = elu(t + 3 < vb ? xv.w + (acc[i][g * 4 + 3] + bias) : 0.f);
            *reinterpret_cast<float4*>(orow + t) = y;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (t + e < t_len) {
                const float y = xr[t + e] + (acc[i][g * 4 + e] + bias);
                orow[t + e] = elu(t + e < vb ? y : 0.f);
              }
            }
          }
        }
      }
      zero();
    }
  }
}

template <int RM, int RN, int TY, int TX, int CL, int CK, int S>
int launch(const float* x, const int* valid, const float* w3p, const float* b3,
           const float* w1p, const float* b1, float* out, int b, int c, int c2, int t_len,
           cudaStream_t stream) {
  using V = Variant<RM, RN, TY, TX, CL, CK, S>;
  auto kernel = resblock_kernel<RM, RN, TY, TX, CL, CK, S>;
  const size_t smem = V::smem_bytes(c2);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size leaves no error behind for the next launch
    return (int)err;
  }
  const int ld3 = (c2 + 3) / 4 * 4, ld1 = (c + 3) / 4 * 4;
  // 16-byte x / out accesses: rows start on 16 bytes and ragged ends are
  // whole groups of 4
  const int vec = t_len % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((t_len + V::TT - 1) / V::TT * CL, b);
  cfg.blockDim = dim3(V::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, x, valid, w3p, b3, w1p, b1, out, c, c2, t_len, ld3, ld1, vec);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, const int*, const float*, const float*, const float*,
                         const float*, float*, int, int, int, int, cudaStream_t);

// The variants: <RM, RN, TY, TX, CL, CK, S>. A cluster's blocks share
// CL * BM rows of h per pass; pick() takes a cluster variant only where
// CL * BM divides C2, so no block multiplies rows of zeros.
constexpr LaunchFn VARIANTS[] = {
    launch<8, 4, 4, 64, 1, 16, 2>,     // 0: BM 32, TT 256
    launch<8, 4, 8, 32, 1, 16, 2>,     // 1: BM 64, TT 128
    launch<8, 4, 8, 32, 2, 16, 2>,     // 2: BM 64, TT 128, CL 2
    launch<4, 4, 16, 16, 4, 16, 2>,    // 3: BM 64, TT 64, CL 4
    launch<4, 4, 16, 8, 4, 16, 2>,     // 4: BM 64, TT 32, CL 4, 128 threads
    launch<4, 4, 8, 16, 4, 16, 2>,     // 5: BM 32, TT 64, CL 4, 128 threads
};

// The fastest variant at the main path's shapes on an H100 (PERF.md): by C,
// and at C >= 256 by the launch's B * T columns, where a smaller tile
// spreads a small launch over more SMs.
int pick(int b, int c2, int t_len) {
  const long cols = (long)b * t_len;
  if (c2 <= 32) return 0;
  if (c2 <= 64) return 1;
  if (c2 <= 128) return cols <= 4096 ? 5 : 2;
  return cols <= 3072 ? 4 : 3;
}

}  // namespace

extern "C" int resblock_elu_launch(const float* x, const int* valid, const float* w3p,
                                   const float* b3, const float* w1p, const float* b1,
                                   float* out, int b, int c, int c2, int t_len, void* stream) {
  if (b <= 0 || t_len <= 0 || c <= 0) return 0;
  return VARIANTS[pick(b, c2, t_len)](x, valid, w3p, b3, w1p, b1, out, b, c, c2, t_len,
                                      static_cast<cudaStream_t>(stream));
}
