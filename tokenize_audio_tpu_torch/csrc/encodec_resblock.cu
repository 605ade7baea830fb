// EnCodec's SEANet resnet block + the ELU after it, hand-written for Hopper.
//
// Replaces no TPU kernel (the JAX package has no EnCodec). It fuses what
// encodec/model.py ran per stage as three cuDNN convolutions and about
// eight elementwise passes (ELU, reflect pad, add, mask, the down-conv's
// ELU) over full-rate activations.
//
// Computes, for x (B, C, T), per-row valid lengths (or none: no mask) and
// the weights packed once by the wrapper (ops/cuda/encodec_resblock.py:
// pack_weights) as w3p (C, 3, C2) = w3[m, c, k] at [c, k, m], wyp (C + C2,
// C) = wsc[m, c, 0] at [c, m] and w1[m, j, 0] at [C + j, m], b3 (C2) and
// by (C) = bsc + b1, with C2 = C / 2:
//   h  = elu(conv3(elu(x)) + b3)     causal 3-tap conv; left of t = 0 the
//                                    reflection of elu(x): columns 2, 1
//   y  = Wsc . x + W1 . h + by       the k1 shortcut on raw x, the k1 conv
//   ye = elu(y masked to 0 at t >= valid[row])
// the EncodecResnetBlock (one a stage, dilation 1, conv shortcut) and the
// stage's following ELU; the strided down-conv runs after it in PyTorch.
// h is not masked: the block's convs see the bucket's zero columns as the
// plain chain does. ELU is expm1f; all arithmetic is IEEE FP32 on the CUDA
// cores (the configuration states IEEE fp32, so no tensor cores).
//
// What bounds it on this card: three channel-mixing products, 6 * C^2 flop
// per time column, against 8 * C bytes (x in, ye out): 24 flop a byte at
// C = 32, near the FP32 ridge (20), and past it at C >= 64. So the
// 67 TFLOP/s FP32 rate at every stage, and at C = 32 the 3.35 TB/s too.
//
// What the design does about it (the structure of csrc/seanet_resblock.cu,
// Mimi's block, which needs zero halos, no shortcut and C 64-512):
//  - One pass of every output row a time tile: a thread owns 4 rows of h
//    and 8 rows of y (as two groups of 4) over 4 columns, so all C2 rows
//    of h and all C rows of y of the tile live in the block's registers
//    (TY = C / 8 thread rows, 256 threads, TT = 8192 / C columns). x is
//    read from device memory once, and ye written once.
//  - A K-loop over chunks of CK input channels through a ring of S stages
//    in shared memory, filled with cp.async, so the next chunk loads while
//    this one is multiplied; one __syncthreads per chunk. A stage of the
//    first product holds the raw x chunk (CK rows of TT columns), its ELU
//    beside it (with the 2-column halo), and the chunk's rows of W3 and of
//    Wsc: each input channel feeds the conv3 sums of h from elu(x) and
//    the shortcut sums of y from raw x in the same step. Each thread
//    writes the ELU of the elements it copied itself once they land,
//    before the barrier, so ELU runs once per element and block.
//  - The ring runs on into the second product's chunks, rows of W1 for
//    CK rows of h, which is held in shared memory and never goes to
//    device memory; y's sums stay in registers across both products.
//  - The halo is the previous two columns of the tile, loaded and ELU'd
//    with the chunk; the tile at t = 0 loads columns 2 and 1 instead (the
//    reflect pad of transformers' EncodecConv1d, which commutes with ELU).
//  - Every shared-memory operand is a 16-byte load (the elu(x) row as
//    float2 + float4, one float4 of raw x, float4 rows of weights, packed so
//    one thread's output rows are contiguous); 256 threads with registers
//    capped at 128, so two blocks share an SM.
//  - The variant is chosen from C (pick(), at the bottom of this file): a
//    tile of 256 columns at C = 32 down to 32 at C = 256 leaves every
//    launch of the cell at least 266 tiles, two a SM, so no launch needs
//    another tile or a cluster to fill the card.
#include <cuda_runtime.h>

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

// One kernel variant for C channels: THREADS threads as TY x TX, TY = C / 8;
// a thread owns h rows ty*4 + (0..3), y rows ty*4 + g*4*TY + (0..3) (g < 2)
// and columns tx*4 + g*4*TX + (0..3) (g < RN/4) of a TT-column tile. CK
// input channels per chunk, S ring stages.
template <int C, int THREADS, int RN, int CK, int S>
struct Variant {
  static constexpr int C2 = C / 2;
  static constexpr int TY = C / 8;
  static constexpr int TX = THREADS / TY;
  static constexpr int TT = RN * TX;        // time columns per tile
  static constexpr int XS = TT + 4;         // elu(x) row: index i <-> column t0 - 4 + i
  static constexpr int XR = TT;             // raw x row: index i <-> column t0 + i
  // a stage: [CK x XR raw x | CK x XS elu(x) | 3*CK x C2 of W3 | CK x C of Wy]
  static constexpr int SLOT = CK * (XR + XS) + 3 * CK * C2 + CK * C;
  static constexpr int N1 = C / CK, N2 = C2 / CK;  // chunks of the two products
  static_assert(C % 8 == 0 && THREADS % TY == 0 && TX >= 1, "threads tile the rows");
  static_assert(RN % 4 == 0, "columns are groups of 4");
  static_assert(C2 % CK == 0 && CK % 4 == 0, "whole chunks in both products");
  static_assert(S >= 2, "a ring needs two stages");
  static constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)S * SLOT + (size_t)C2 * TT);
  }
};

// two blocks per SM: at 256 threads, registers are capped at 128
template <int C, int THREADS, int RN, int CK, int S>
__global__ void __launch_bounds__(THREADS, 2)
encodec_resblock_kernel(const float* __restrict__ x, const int* __restrict__ valid,
                        const float* __restrict__ w3p, const float* __restrict__ b3,
                        const float* __restrict__ wyp, const float* __restrict__ by,
                        float* __restrict__ out, int t_len, int vec) {
  using V = Variant<C, THREADS, RN, CK, S>;
  constexpr int C2 = V::C2, TY = V::TY, TX = V::TX, TT = V::TT, XS = V::XS, XR = V::XR;
  constexpr int SLOT = V::SLOT, N1 = V::N1, N_ALL = V::N1 + V::N2;
  constexpr int GC = RN / 4;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;            // S x SLOT
  float* h_s = smem + S * SLOT;  // C2 x TT

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int t0 = blockIdx.x * TT;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * C * t_len;
  float* ob = out + (size_t)b * C * t_len;
  const int vb = valid != nullptr ? valid[b] : t_len;

  // --- chunk q -> ring slot q % S
  auto load_chunk = [&](int q) {
    float* xr = ring + (q % S) * SLOT;
    float* xe = xr + CK * XR;
    float* w3s = xe + CK * XS;
    float* wys = w3s + 3 * CK * C2;
    int wrow;  // the chunk's first row of Wy
    if (q < N1) {
      const int c0 = q * CK;
      wrow = c0;
      for (int i = tid; i < CK * (TT / 4); i += THREADS) {
        const int cc = i / (TT / 4), t = t0 + (i % (TT / 4)) * 4;
        float* dst = xr + cc * XR + (t - t0);
        const float* src = xb + (size_t)(c0 + cc) * t_len + t;
        if (vec) {
          const bool ok = t < t_len;
          cp_async16(dst, ok ? src : xb, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = t + e < t_len;
            cp_async4(dst + e, ok ? src + e : xb, ok);
          }
        }
      }
      // the halo, raw, into the elu(x) rows: columns t0 - 2, t0 - 1, or at
      // t0 = 0 their reflection, columns 2, 1 (t_len >= 3)
      for (int i = tid; i < CK * 2; i += THREADS) {
        const int cc = i / 2, tc = t0 - 2 + i % 2, t = tc < 0 ? -tc : tc;
        const bool ok = t < t_len;
        cp_async4(xe + cc * XS + 2 + i % 2, ok ? xb + (size_t)(c0 + cc) * t_len + t : xb, ok);
      }
      for (int i = tid; i < 3 * CK * (C2 / 4); i += THREADS) {
        const int r = i / (C2 / 4), m = (i % (C2 / 4)) * 4;
        cp_async16(w3s + r * C2 + m, w3p + ((size_t)c0 * 3 + r) * C2 + m, true);
      }
    } else {
      wrow = C + (q - N1) * CK;
    }
    for (int i = tid; i < CK * (C / 4); i += THREADS) {
      const int r = i / (C / 4), m = (i % (C / 4)) * 4;
      cp_async16(wys + r * C + m, wyp + (size_t)(wrow + r) * C + m, true);
    }
  };
  // elu(x) of the elements this thread copied (visible to it after its own
  // wait_group): the body from the raw rows, the halo in place
  auto elu_own = [&](int q) {
    float* xr = ring + (q % S) * SLOT;
    float* xe = xr + CK * XR;
    for (int i = tid; i < CK * (TT / 4); i += THREADS) {
      const int cc = i / (TT / 4), col = (i % (TT / 4)) * 4;
      *reinterpret_cast<float4*>(xe + cc * XS + 4 + col) =
          elu4(*reinterpret_cast<const float4*>(xr + cc * XR + col));
    }
    for (int i = tid; i < CK * 2; i += THREADS) {
      float* p = xe + (i / 2) * XS + 2 + i % 2;
      *p = elu(*p);
    }
  };

  float acc_h[4][RN], acc_y[8][RN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc_h[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc_y[i][j] = 0.f;

#pragma unroll
  for (int q = 0; q < S - 1; ++q) {
    if (q < N_ALL) load_chunk(q);
    cp_async_commit();
  }

  for (int q = 0; q < N_ALL; ++q) {
    cp_async_wait<S - 2>();
    if (q < N1) elu_own(q);
    __syncthreads();  // chunk q visible; every thread is done with chunk q - 1
    if (q + S - 1 < N_ALL) load_chunk(q + S - 1);  // into the slot of chunk q - 1
    cp_async_commit();

    const float* xr = ring + (q % S) * SLOT;
    const float* xe = xr + CK * XR;
    const float* w3s = xe + CK * XS;
    const float* wys = w3s + 3 * CK * C2;
    if (q < N1) {
      // h += W3[:, c, k] . elu(x)[c, t - 2 + k];  y += Wsc[:, c] . x[c, t]
      for (int cc = 0; cc < CK; ++cc) {
        float v[GC][6], r[GC][4];
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const int col = tx * 4 + g * 4 * TX;
          const float2 lo = *reinterpret_cast<const float2*>(xe + cc * XS + col + 2);
          const float4 hi = *reinterpret_cast<const float4*>(xe + cc * XS + col + 4);
          const float4 raw = *reinterpret_cast<const float4*>(xr + cc * XR + col);
          v[g][0] = lo.x; v[g][1] = lo.y;
          v[g][2] = hi.x; v[g][3] = hi.y; v[g][4] = hi.z; v[g][5] = hi.w;
          r[g][0] = raw.x; r[g][1] = raw.y; r[g][2] = raw.z; r[g][3] = raw.w;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(w3s + (cc * 3 + k) * C2 + ty * 4);
          const float w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int g = 0; g < GC; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc_h[i][g * 4 + e] = fmaf(w[i], v[g][e + k], acc_h[i][g * 4 + e]);
        }
        float w[8];
#pragma unroll
        for (int gr = 0; gr < 2; ++gr) {
          const float4 a = *reinterpret_cast<const float4*>(wys + cc * C + ty * 4 + gr * 4 * TY);
          w[gr * 4] = a.x; w[gr * 4 + 1] = a.y; w[gr * 4 + 2] = a.z; w[gr * 4 + 3] = a.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int g = 0; g < GC; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc_y[i][g * 4 + e] = fmaf(w[i], r[g][e], acc_y[i][g * 4 + e]);
      }
    } else {
      // y += W1[:, j] . h[j, t]
      const float* hs = h_s + (size_t)((q - N1) * CK) * TT;
#pragma unroll 4
      for (int cc = 0; cc < CK; ++cc) {
        float hv[RN], w[8];
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4 a = *reinterpret_cast<const float4*>(hs + cc * TT + tx * 4 + g * 4 * TX);
          hv[g * 4] = a.x; hv[g * 4 + 1] = a.y; hv[g * 4 + 2] = a.z; hv[g * 4 + 3] = a.w;
        }
#pragma unroll
        for (int gr = 0; gr < 2; ++gr) {
          const float4 a = *reinterpret_cast<const float4*>(wys + cc * C + ty * 4 + gr * 4 * TY);
          w[gr * 4] = a.x; w[gr * 4 + 1] = a.y; w[gr * 4 + 2] = a.z; w[gr * 4 + 3] = a.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc_y[i][j] = fmaf(w[i], hv[j], acc_y[i][j]);
      }
    }

    if (q == N1 - 1) {
      // the first product is done: h = elu(acc + b3) into shared memory,
      // read by the second product's chunks after the next barrier
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty * 4 + i;
        const float bias = b3[m];
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          *reinterpret_cast<float4*>(h_s + (size_t)m * TT + tx * 4 + g * 4 * TX) =
              elu4(make_float4(acc_h[i][g * 4] + bias, acc_h[i][g * 4 + 1] + bias,
                               acc_h[i][g * 4 + 2] + bias, acc_h[i][g * 4 + 3] + bias));
        }
      }
    }
  }

  // ye = elu(mask(acc + by))
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = ty * 4 + (i / 4) * 4 * TY + i % 4;
    const float bias = by[m];
    float* orow = ob + (size_t)m * t_len;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const int t = t0 + tx * 4 + g * 4 * TX;
      if (vec) {
        if (t >= t_len) continue;
        float4 y;
        y.x = t < vb ? elu(acc_y[i][g * 4] + bias) : 0.f;
        y.y = t + 1 < vb ? elu(acc_y[i][g * 4 + 1] + bias) : 0.f;
        y.z = t + 2 < vb ? elu(acc_y[i][g * 4 + 2] + bias) : 0.f;
        y.w = t + 3 < vb ? elu(acc_y[i][g * 4 + 3] + bias) : 0.f;
        *reinterpret_cast<float4*>(orow + t) = y;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (t + e < t_len) orow[t + e] = t + e < vb ? elu(acc_y[i][g * 4 + e] + bias) : 0.f;
        }
      }
    }
  }
}

template <int C, int THREADS, int RN, int CK, int S>
int launch(const float* x, const int* valid, const float* w3p, const float* b3, const float* wyp,
           const float* by, float* out, int b, int t_len, cudaStream_t stream) {
  using V = Variant<C, THREADS, RN, CK, S>;
  auto kernel = encodec_resblock_kernel<C, THREADS, RN, CK, S>;
  constexpr size_t smem = V::smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size leaves no error behind for the next launch
    return (int)err;
  }
  // 16-byte x / out accesses: rows start on 16 bytes and ragged ends are
  // whole groups of 4
  const int vec = t_len % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0;
  const dim3 grid((t_len + V::TT - 1) / V::TT, b);
  kernel<<<grid, THREADS, smem, stream>>>(x, valid, w3p, b3, wyp, by, out, t_len, vec);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, const int*, const float*, const float*, const float*,
                         const float*, float*, int, int, cudaStream_t);

// The variants: <C, THREADS, RN, CK, S>, the fastest of those timed over
// the EnCodec cell's 28 batches at each width on an H100 (PERF.md: 128
// threads at C <= 64, or CK 8 at any width, each took 7-27 % more).
constexpr LaunchFn VARIANTS[] = {
    launch<32, 256, 4, 16, 2>,   // 0: TT 256
    launch<64, 256, 4, 16, 3>,   // 1: TT 128
    launch<128, 256, 4, 16, 3>,  // 2: TT 64
    launch<256, 256, 4, 16, 2>,  // 3: TT 32
};

// by C; -1 for a width the kernel does not take
int pick(int c) {
  switch (c) {
    case 32: return 0;
    case 64: return 1;
    case 128: return 2;
    case 256: return 3;
    default: return -1;
  }
}

}  // namespace

extern "C" int encodec_resblock_launch(const float* x, const int* valid, const float* w3p,
                                       const float* b3, const float* wyp, const float* by,
                                       float* out, int b, int c, int t_len, void* stream) {
  if (b <= 0 || t_len <= 0) return 0;
  const int v = pick(c);
  if (v < 0) return (int)cudaErrorInvalidValue;
  return VARIANTS[v](x, valid, w3p, b3, wyp, by, out, b, t_len, static_cast<cudaStream_t>(stream));
}
