// Chained residual-vector-quantization search, hand-written for Hopper.
//
// Replaces: tokenize_audio_tpu/ops/pallas/rvq.py, rvq_quantize_pallas ->
// _rvq_kernel (the TPU kernel carries the residual in VMEM scratch from one
// sequential grid step, i.e. one codebook, to the next).
//
// Computes, for each row r of x (N, D) and each book k = 0..K-1 in order:
//   d2[v] = (|r|^2 - 2 * r.E_k[v]) + |E_k[v]|^2
//   idx   = first-index argmin_v d2[v]
//   r    <- r - E_k[idx]
// and writes codes (N, K) int32. |E_k[v]|^2 arrives precomputed (e2, (K, V)),
// as the TPU wrapper computes it outside its kernel.
//
// What bounds it on this card: the distance products, K*N*V*2D flop over
// ~4*(K*V*D + N*D) bytes, hundreds of flop per byte, so the FP32 CUDA-core
// rate (the parity mode excludes TF32, so no tensor cores).
//
// What the design does about that: blocks run in parallel and in no order,
// so instead of a sequential grid one thread-block CLUSTER owns a tile of
// TM rows and loops over all K books itself. The cluster's CL blocks split
// each codebook into CL slices, one per SM, so a batch of few rows still
// spreads over many SMs (CL = 8 for small batches, 4 otherwise). Every
// block keeps its own copy of the residual tile in shared memory for the
// whole chain; codebook slices stream through a double-buffered shared
// memory tile with cp.async (the next TD-deep chunk loads while the current
// one is used, across book boundaries too), and each thread accumulates an
// 8 x RN register tile of products. Each thread keeps a running (min,
// argmin) scanning its codewords upward with a strict '<'; the reductions
// (across the block, then across the cluster through distributed shared
// memory) break equal distances toward the smaller index, which gives
// first-index ties like torch.argmin. Every block then applies the same
// gather update r -= E_k[idx] (L2-resident), so the residual copies stay
// identical. Ragged N, D and V are masked, not padded in memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TM = 32;            // rows per cluster
constexpr int TD = 16;            // depth per staged codebook chunk
constexpr int RM = 8;             // rows per thread
constexpr int GY = TM / RM;       // 4 row groups
constexpr int GX = 64;            // codeword lanes
constexpr int THREADS = GY * GX;  // 256
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// 4-byte asynchronous global->shared copy; src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

template <int RN, int CL>
__global__ void __launch_bounds__(THREADS, 2)
rvq_kernel(const float* __restrict__ x, const float* __restrict__ embeds,
           const float* __restrict__ e2, int* __restrict__ out, int n, int d,
           int n_books, int v, int dp) {
  constexpr int TV = GX * RN;  // codewords per tile
  constexpr int ES = TV + 1;   // padded stride of the transposed tile e_s[dd][v]
  extern __shared__ float smem[];
  float* r_s = smem;                         // dp x TM residual, transposed
  float* e_s = r_s + dp * TM;                // 2 x TD x ES codebook chunks, transposed
  float* x2_s = e_s + 2 * TD * ES;           // TM
  float* part_s = x2_s + TM;                 // WARPS x TM partial sums
  float* wbest_s = part_s + WARPS * TM;      // WARPS x RM per-warp minima
  int* widx_s = reinterpret_cast<int*>(wbest_s + WARPS * RM);     // WARPS x RM
  float* cand_d = reinterpret_cast<float*>(widx_s + WARPS * RM);  // 2 x TM
  int* cand_i = reinterpret_cast<int*>(cand_d + 2 * TM);          // 2 x TM
  int* idx_s = cand_i + 2 * TM;                                   // TM

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int gx = tid % GX, gy = tid / GX;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = (blockIdx.x / CL) * TM;
  const int vs = (v + CL - 1) / CL;  // codewords per slice
  const int vlo = rank * vs;
  const int vhi = min(v, vlo + vs);
  const int n_vt = vhi > vlo ? (vhi - vlo + TV - 1) / TV : 0;
  const int n_dc = dp / TD;
  const int per_book = n_vt * n_dc;
  const int total = n_books * per_book;

  // chunk c = ((book * n_vt) + v tile) * n_dc + d chunk, into buffer c & 1
  auto issue = [&](int c) {
    const int kb = c / per_book, rem = c % per_book;
    const int v0 = vlo + (rem / n_dc) * TV, d0 = (rem % n_dc) * TD;
    const float* e = embeds + (size_t)kb * v * d;
    float* buf = e_s + (c & 1) * TD * ES;
    for (int i = tid; i < TV * TD; i += THREADS) {
      const int dd = i % TD, vv = i / TD, gv = v0 + vv, gd = d0 + dd;
      const bool ok = gv < vhi && gd < d;
      cp_async4(&buf[dd * ES + vv], ok ? e + (size_t)gv * d + gd : e, ok);
    }
    cp_async_commit();
  };

  for (int i = tid; i < TM * dp; i += THREADS) {
    const int r = i % TM, c = i / TM, gr = row0 + r;
    r_s[i] = (gr < n && c < d) ? x[(size_t)gr * d + c] : 0.f;
  }
  if (total > 0) issue(0);
  int chunk = 0;

  for (int kb = 0; kb < n_books; ++kb) {
    // |r|^2 per row: warp w sums columns c = w (mod WARPS) for all TM rows
    __syncthreads();
    {
      float s = 0.f;
      for (int c = warp; c < d; c += WARPS) {
        const float q = r_s[c * TM + lane];
        s += q * q;
      }
      part_s[warp * TM + lane] = s;
    }
    __syncthreads();
    if (tid < TM) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += part_s[w * TM + tid];
      x2_s[tid] = s;
    }

    const float* e2k = e2 + (size_t)kb * v;
    float best[RM];
    int bidx[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      best[i] = CUDART_INF_F;
      bidx[i] = 0x7fffffff;
    }
    for (int vt = 0; vt < n_vt; ++vt) {
      const int v0 = vlo + vt * TV;
      float acc[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
      for (int dc = 0; dc < n_dc; ++dc, ++chunk) {
        if (chunk + 1 < total) {
          issue(chunk + 1);  // its buffer's readers finished at the last barrier
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // this chunk (and x2_s) visible to every thread
        const float* buf = e_s + (chunk & 1) * TD * ES;
        const int d0 = dc * TD;
#pragma unroll 4
        for (int dd = 0; dd < TD; ++dd) {
          const float4 a0 = *reinterpret_cast<const float4*>(&r_s[(d0 + dd) * TM + gy * RM]);
          const float4 a1 = *reinterpret_cast<const float4*>(&r_s[(d0 + dd) * TM + gy * RM + 4]);
          const float a[RM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          float b[RN];
#pragma unroll
          for (int j = 0; j < RN; ++j) b[j] = buf[dd * ES + gx + GX * j];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();  // done reading this buffer before it is refilled
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gv = v0 + gx + GX * j;  // ascending per thread
        if (gv < vhi) {
          const float ev = e2k[gv];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float dist = (x2_s[gy * RM + i] - 2.f * acc[i][j]) + ev;
            if (dist < best[i]) {
              best[i] = dist;
              bidx[i] = gv;
            }
          }
        }
      }
    }

    // block minimum per row: across the warp, then across the two warps of
    // a row group
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
        if (better(ob, oi, best[i], bidx[i])) {
          best[i] = ob;
          bidx[i] = oi;
        }
      }
      if (lane == 0) {
        wbest_s[warp * RM + i] = best[i];
        widx_s[warp * RM + i] = bidx[i];
      }
    }
    __syncthreads();
    const int par = kb & 1;
    if (tid < TM) {
      const int w0 = (tid / RM) * (GX / 32), i = tid % RM;
      float bd = wbest_s[w0 * RM + i];
      int bi = widx_s[w0 * RM + i];
      for (int w = w0 + 1; w < w0 + GX / 32; ++w) {
        if (better(wbest_s[w * RM + i], widx_s[w * RM + i], bd, bi)) {
          bd = wbest_s[w * RM + i];
          bi = widx_s[w * RM + i];
        }
      }
      cand_d[par * TM + tid] = bd;
      cand_i[par * TM + tid] = bi;
    }
    // cluster minimum per row, read from every block's shared memory; the
    // candidate buffers alternate by book, so one cluster barrier per book
    // keeps a fast block from overwriting what a slow one still reads
    cluster.sync();
    if (tid < TM) {
      float bd = CUDART_INF_F;
      int bi = 0x7fffffff;
      for (int q = 0; q < CL; ++q) {
        const float* rd = cluster.map_shared_rank(cand_d, q);
        const int* ri = cluster.map_shared_rank(cand_i, q);
        if (better(rd[par * TM + tid], ri[par * TM + tid], bd, bi)) {
          bd = rd[par * TM + tid];
          bi = ri[par * TM + tid];
        }
      }
      bi = bi < v ? bi : 0;  // all distances NaN: index 0, never out of range
      idx_s[tid] = bi;
      if (rank == 0 && row0 + tid < n) out[(size_t)(row0 + tid) * n_books + kb] = bi;
    }
    __syncthreads();
    const float* e = embeds + (size_t)kb * v * d;
    for (int i = tid; i < TM * d; i += THREADS) {
      const int r = i % TM, c = i / TM;
      r_s[c * TM + r] -= e[(size_t)idx_s[r] * d + c];
    }
  }
  cluster.sync();  // no block leaves while another may still read its candidates
}

template <int RN, int CL>
int launch(const float* x, const float* embeds, const float* e2, int* out, int n, int d,
           int n_books, int v, cudaStream_t stream) {
  const int dp = (d + TD - 1) / TD * TD;
  const size_t smem =
      sizeof(float) * ((size_t)dp * TM + 2 * (size_t)TD * (GX * RN + 1) + TM + WARPS * TM +
                       WARPS * RM + 2 * TM) +
      sizeof(int) * (WARPS * RM + 2 * TM + TM);
  cudaError_t err = cudaFuncSetAttribute(
      rvq_kernel<RN, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + TM - 1) / TM * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rvq_kernel<RN, CL>, x, embeds, e2, out, n, d, n_books, v, dp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Clusters of 4 blocks (512-codeword tiles) when the row tiles alone give a
// wave of blocks; clusters of 8 (256-codeword tiles) for smaller batches.
extern "C" int rvq_quantize_launch(const float* x, const float* embeds,
                                   const float* e2, int* out, int n, int d,
                                   int n_books, int v, void* stream) {
  if (n <= 0 || n_books <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + TM - 1) / TM;
  if (tiles * 4 >= sms) return launch<8, 4>(x, embeds, e2, out, n, d, n_books, v, s);
  return launch<4, 8>(x, embeds, e2, out, n, d, n_books, v, s);
}
