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
// and writes codes (N, K) int32. The codebooks arrive twice: packed
// (cb (K, D, VP), cb[k, d, v] = E_k[v, d], VP = V rounded up to 4 with
// zero columns, and e2 (K, V) = |E_k[v]|^2, both made once by
// ops/cuda/rvq.py::pack_codebooks) for the distance products, and in their
// own (K, V, D) layout for the gather r -= E_k[idx].
//
// What bounds it on this card: the distance products, K*N*V*2D flop over
// ~4*(K*V*D + N*D) bytes, so the FP32 CUDA-core rate (the parity mode
// excludes TF32, so no tensor cores). But the main path launches it on
// batches of 13-824 rows: there a few row tiles hold the card for a chain of
// K books in series, and each book of a tile costs a fixed latency (its
// chunk pipeline, the argmin reductions, a cluster barrier and the residual
// update) besides its share of the products.
//
// What the design does about that:
// - One thread-block CLUSTER owns a tile of TM rows for all K books, and its
//   CL blocks split every codebook's V codewords into CL slices, one per SM,
//   so a book of a small batch runs on 8-16 SMs at once. Small batches take
//   16-row tiles in clusters of 16 (a non-portable size), so a 13-row batch
//   is 16 blocks of 16 rows x 128 codewords per book; larger batches take
//   48- and 32-row tiles. pick() chooses the variant from N at launch: the
//   largest per-book share of the card whose row tiles still fit one wave
//   of clusters.
// - Codebook chunks (TD = 16, 32 or 64 depths x one pass of TV codewords)
//   stream into a ring of 3-5 chunks in shared memory with 16-byte cp.async
//   copies from the packed layout (no transposition on the way), each
//   thread's copy addresses stepped from chunk to chunk without divisions,
//   one barrier per chunk. The ring's chunk counter runs over passes and
//   books alike, so the next book's first chunks are in flight while this
//   book's argmin, cluster reduction and residual update run.
// - Each warp holds every row of the tile and its own codewords; its lanes
//   form a 2-D grid of row and codeword groups, each thread an RM x RN
//   register tile (RM rows of the row-major residual tile, RN adjacent
//   codewords per vector load), so one shared-memory load feeds 4-8 FMAs.
// - (distance, index) pairs are reduced as one ordered 64-bit key (the
//   float's bits mapped to an unsigned order, then the index), so every
//   reduction -- across the warp, the block and the cluster, the last
//   through distributed shared memory -- breaks equal distances toward the
//   smaller index, like torch.argmin, in a fixed order.
// - The residual update walks the chosen codeword along D with the warp's
//   lanes (coalesced, conflict-free) and folds |r|^2 into the same pass.
// Ragged N, D and V are masked, not padded in memory (past VP, past D, past
// N); every block keeps the same residual copy, and cluster rank 0 writes
// the codes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
typedef unsigned long long u64;

// A block: TM rows x TV codewords per pass. Every warp holds all TM rows
// and its own TV / WARPS codewords; its lanes form LR row groups x LC
// codeword groups, each thread an RM x RN tile (rows r, r + LR, ...; RN
// adjacent codewords), so one shared-memory load feeds many FMAs. The
// codebook ring holds RING_KB kilobytes of TD-deep chunks.
template <int TM, int RM, int RN, int CL, int LR, int TD, int RING_KB>
struct Tile {
  static constexpr int LC = 32 / LR;
  static constexpr int TV = WARPS * LC * RN;
  static constexpr int STAGES = RING_KB * 1024 / (TD * TV * 4);
  static constexpr int AW = RM * RN >= 32 ? 2 : 4;  // depths per residual load
  // blocks per SM: two where their shared memory fits, so registers are capped
  static constexpr int MINB = RING_KB <= 64 ? 2 : 1;
  static_assert(LR * RM == TM && LR * LC == 32, "a warp holds every row once");
  static constexpr int COPIES = TD * TV / 4 / THREADS;  // 16-byte copies per thread and chunk
  static_assert(STAGES >= 3 && TD % AW == 0, "ring of at least 3 chunks");
  static_assert(COPIES * 4 * THREADS == TD * TV && THREADS % (TV / 4) == 0, "whole copies");
};

// (distance, index) -> one key whose unsigned order is (distance, index)
// order; -0 counts as +0 and NaN above every number, so a NaN is chosen only
// when every distance of the row is NaN (then the smallest index)
__device__ __forceinline__ u64 make_key(float dist, int idx) {
  unsigned b = __float_as_uint(dist);
  if (dist != dist) b = 0xffffffffu;
  else if (b == 0x80000000u) b = 0x80000000u;  // -0: the key of +0
  else b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)b << 32) | (unsigned)idx;
}
__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return b < a ? b : a; }

// 16-byte asynchronous global->shared copy (L2 only); src_bytes = 0 writes
// zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

template <int W>
__device__ __forceinline__ void load_vec(float (&b)[W], const float* p) {
  static_assert(W == 2 || W == 4, "16- or 8-byte vectors");
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    b[0] = t.x; b[1] = t.y; b[2] = t.z; b[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    b[0] = t.x; b[1] = t.y;
  }
}

template <int TM, int RM, int RN, int CL, int LR, int TD, int RING_KB>
__global__ void __launch_bounds__(THREADS, (Tile<TM, RM, RN, CL, LR, TD, RING_KB>::MINB))
rvq_kernel(const float* __restrict__ x, const float* __restrict__ cb,
           const float* __restrict__ e2, const float* __restrict__ embeds,
           int* __restrict__ out, int n, int d, int n_books, int v, int vp, int dp) {
  using T = Tile<TM, RM, RN, CL, LR, TD, RING_KB>;
  constexpr int LC = T::LC, TV = T::TV, S = T::STAGES, AW = T::AW;
  // residual rows are dp + 4 floats apart: the LR rows one load instruction
  // reads fall in distinct banks
  const int rs = dp + 4;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                      // S x TD x TV
  float* r_s = ring + S * TD * TV;                         // TM x rs residual
  u64* wkey_s = reinterpret_cast<u64*>(r_s + TM * rs);     // WARPS x TM
  u64* cand_s = wkey_s + WARPS * TM;                       // 2 x TM
  float* x2_s = reinterpret_cast<float*>(cand_s + 2 * TM); // TM
  int* idx_s = reinterpret_cast<int*>(x2_s + TM);          // TM

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = lane / LC, lc = lane % LC;  // this thread's row and codeword group
  int rank = 0;
  if constexpr (CL > 1) rank = (int)cg::this_cluster().block_rank();
  const int row0 = (blockIdx.x / CL) * TM;
  const int vs = ((v + CL - 1) / CL + 3) / 4 * 4;  // slice, 16-byte aligned
  const int vlo = min(v, rank * vs), vhi = min(v, vlo + vs);
  const int n_pass = (vhi - vlo + TV - 1) / TV;
  const int n_dc = dp / TD;
  const int per_book = n_pass * n_dc;
  const int total = n_books * per_book;

  // chunks are asked for in order c = (book * n_pass + pass) * n_dc + depth
  // chunk, into slot c % S; past the last chunk an empty group keeps the
  // wait counts uniform. Thread t copies 16 bytes at depths dd0 + i * DSTEP
  // and columns vv .. vv + 3 of every chunk.
  constexpr int DSTEP = THREADS / (TV / 4);
  const int dd0 = tid / (TV / 4), vv = (tid % (TV / 4)) * 4;
  int next = 0, nkb = 0, np = 0, ndc = 0;  // the next chunk to ask for
  auto issue = [&]() {
    if (next < total) {
      const int d0 = ndc * TD, gv = vlo + np * TV + vv;
      const float* src = cb + ((size_t)nkb * d + d0 + dd0) * vp + gv;
      float* buf = ring + (next % S) * (TD * TV) + dd0 * TV + vv;
#pragma unroll
      for (int i = 0; i < T::COPIES; ++i) {
        const bool ok = d0 + dd0 + i * DSTEP < d && gv < vp;
        cp_async16(buf + i * DSTEP * TV, ok ? src + (size_t)i * DSTEP * vp : cb, ok);
      }
      if (++ndc == n_dc) {
        ndc = 0;
        if (++np == n_pass) {
          np = 0;
          ++nkb;
        }
      }
    }
    ++next;
    cp_async_commit();
  };

  // r -= E_kb[idx] (kb >= 0) and |r|^2: warp w takes rows w, w + WARPS, ...,
  // lanes along D; the rows' gathers are unrolled so that they are all in
  // flight at once
  auto rows_pass = [&](int kb) {
    constexpr int RPW = (TM + WARPS - 1) / WARPS;
    float s[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp + j * WARPS;
      s[j] = 0.f;
      if (r < TM) {
        float* rr = r_s + r * rs;
        const float* e = embeds + ((size_t)max(kb, 0) * v + idx_s[r]) * d;
#pragma unroll 8
        for (int c = lane; c < d; c += 32) {
          float q = rr[c];
          if (kb >= 0) {
            q -= __ldg(e + c);
            rr[c] = q;
          }
          s[j] = fmaf(q, q, s[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      if (lane == 0 && warp + j * WARPS < TM) x2_s[warp + j * WARPS] = s[j];
    }
  };

  for (int s = 0; s < S - 1; ++s) issue();
  for (int i = tid; i < TM * dp; i += THREADS) {
    const int r = i / dp, c = i - r * dp, gr = row0 + r;
    r_s[r * rs + c] = (gr < n && c < d) ? x[(size_t)gr * d + c] : 0.f;
  }
  if (tid < TM) idx_s[tid] = 0;
  __syncthreads();
  rows_pass(-1);

  int c = 0;
  for (int kb = 0; kb < n_books; ++kb) {
    const float* e2k = e2 + (size_t)kb * v;
    u64 best[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) best[i] = ~0ull;
    for (int p = 0; p < n_pass; ++p) {
      const int vb = vlo + p * TV + (warp * LC + lc) * RN;  // this thread's RN codewords
      float ev[RN];
#pragma unroll
      for (int j = 0; j < RN; ++j) ev[j] = vb + j < vhi ? __ldg(e2k + vb + j) : 0.f;
      float acc[RM][RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
      for (int dc = 0; dc < n_dc; ++dc, ++c) {
        cp_async_wait<S - 2>();
        __syncthreads();  // chunk c landed for all; slot (c - 1) % S is free
        issue();  // chunk c + S - 1
        const float* buf = ring + (c % S) * (TD * TV) + (warp * LC + lc) * RN;
        const float* ar = r_s + lr * rs + dc * TD;
#pragma unroll
        for (int dd = 0; dd < TD; dd += AW) {
          float a[RM][AW];
#pragma unroll
          for (int i = 0; i < RM; ++i) load_vec<AW>(a[i], ar + i * LR * rs + dd);
#pragma unroll
          for (int q = 0; q < AW; ++q) {
            float b[RN];
            load_vec<RN>(b, buf + (dd + q) * TV);
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
              for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float x2 = x2_s[i * LR + lr];
#pragma unroll
        for (int j = 0; j < RN; ++j)
          if (vb + j < vhi)
            best[i] = kmin(best[i], make_key((x2 - 2.f * acc[i][j]) + ev[j], vb + j));
      }
    }

    // minimum per row: across the warp's codeword groups, the warps, the
    // cluster's blocks
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int off = LC / 2; off > 0; off >>= 1)
        best[i] = kmin(best[i], __shfl_xor_sync(0xffffffffu, best[i], off));
    }
    if (lc == 0) {
#pragma unroll
      for (int i = 0; i < RM; ++i) wkey_s[warp * TM + i * LR + lr] = best[i];
    }
    __syncthreads();
    const int par = kb & 1;
    if (tid < TM) {
      u64 k = ~0ull;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) k = kmin(k, wkey_s[w * TM + tid]);
      cand_s[par * TM + tid] = k;
    }
    // the candidate slots alternate by book, so one cluster barrier per book
    // keeps a fast block from overwriting what a slow one still reads
    if constexpr (CL > 1) cg::this_cluster().sync();
    else __syncthreads();
    if (tid < TM) {
      u64 k = ~0ull;
      if constexpr (CL > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        u64 got[CL];
#pragma unroll
        for (int q = 0; q < CL; ++q) got[q] = *cluster.map_shared_rank(cand_s + par * TM + tid, q);
#pragma unroll
        for (int q = 0; q < CL; ++q) k = kmin(k, got[q]);
      } else {
        k = cand_s[par * TM + tid];
      }
      int bi = (int)(unsigned)(k & 0xffffffffu);
      bi = (unsigned)bi < (unsigned)v ? bi : 0;  // never out of range
      idx_s[tid] = bi;
      if (rank == 0 && row0 + tid < n) out[(size_t)(row0 + tid) * n_books + kb] = bi;
    }
    __syncthreads();
    rows_pass(kb);  // the next chunk's barrier publishes r_s and x2_s
  }
  // no block leaves while another may still read its candidates
  if constexpr (CL > 1) cg::this_cluster().sync();
}

struct Args {
  const float *x, *cb, *e2, *embeds;
  int* out;
  int n, d, n_books, v;
};

// the launch configuration of a variant for `rows` rows; its attributes set
template <int TM, int RM, int RN, int CL, int LR, int TD, int RING_KB>
cudaError_t configure(int rows, int d, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  using T = Tile<TM, RM, RN, CL, LR, TD, RING_KB>;
  const int dp = (d + TD - 1) / TD * TD;
  const size_t smem = sizeof(float) * ((size_t)T::STAGES * TD * T::TV + (size_t)TM * (dp + 4) +
                                       2 * TM) +
                      sizeof(u64) * (WARPS * TM + 2 * TM);
  auto kern = rvq_kernel<TM, RM, RN, CL, LR, TD, RING_KB>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && CL > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = {};
  cfg->gridDim = dim3((rows + TM - 1) / TM * CL);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <int TM, int RM, int RN, int CL, int LR, int TD, int RING_KB>
int launch(const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<TM, RM, RN, CL, LR, TD, RING_KB>(a.n, a.d, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = stream;
  const int dp = (a.d + TD - 1) / TD * TD, vp = (a.v + 3) / 4 * 4;
  err = cudaLaunchKernelEx(&cfg, rvq_kernel<TM, RM, RN, CL, LR, TD, RING_KB>, a.x, a.cb, a.e2,
                           a.embeds, a.out, a.n, a.d, a.n_books, a.v, vp, dp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// how many clusters of a variant the card holds at once, at depth d
template <int TM, int RM, int RN, int CL, int LR, int TD, int RING_KB>
int max_clusters(int d, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<TM, RM, RN, CL, LR, TD, RING_KB>(TM * 1024, d, &cfg, attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, rvq_kernel<TM, RM, RN, CL, LR, TD, RING_KB>,
                                         &cfg);
  return (int)err;
}

struct Variant {
  int (*run)(const Args&, cudaStream_t);
  int (*occupancy)(int, int*);
};

// <TM rows, RM x RN per thread, CL blocks per cluster, LR row groups per
// warp, TD depths per chunk, ring kilobytes>
#define RVQ_VARIANT(...) {launch<__VA_ARGS__>, max_clusters<__VA_ARGS__>}
const Variant VARIANTS[] = {
    RVQ_VARIANT(16, 2, 4, 16, 8, 64, 176),  // 0: 16 rows, 16 slices of 128 codewords
    RVQ_VARIANT(16, 4, 4, 8, 4, 64, 192),   // 1: 16 rows, 8 slices of 256
    RVQ_VARIANT(48, 6, 4, 16, 8, 64, 128),  // 2: 48 rows, 16 slices of 128
    RVQ_VARIANT(48, 12, 4, 8, 4, 32, 128),  // 3: 48 rows, 8 slices of 256
    RVQ_VARIANT(32, 8, 4, 8, 4, 16, 64),    // 4: 32 rows, 8 slices of 256, 2 blocks per SM
    RVQ_VARIANT(32, 8, 4, 2, 4, 16, 64),    // 5: 32 rows, 2 slices of 4 x 256, 2 per SM
};
constexpr int N_VARIANTS = sizeof(VARIANTS) / sizeof(VARIANTS[0]);

// The variant for a batch of n rows, from timing every variant at each row
// count the main path launches (13-824) on an H100 SXM (PERF.md). A
// variant wins while its row tiles still fit one wave of clusters: the
// card holds 7 clusters of 16 and 15 clusters of 8 of the one-block-per-SM
// variants at once, and 30 clusters of 8 of variant 4
// (cudaOccupancyMaxActiveClusters); a second wave costs a whole chain of
// books again. Past 2048 rows variant 5's 132 clusters of 2 fill the card.
int pick(int n) {
  if (n <= 7 * 16) return 0;
  if (n <= 15 * 16) return 1;
  if (n <= 7 * 48) return 2;
  if (n <= 15 * 48) return 3;
  return n <= 2048 ? 4 : 5;
}

}  // namespace

extern "C" int rvq_quantize_launch(const float* x, const float* cb, const float* e2,
                                   const float* embeds, int* out, int n, int d, int n_books,
                                   int v, void* stream) {
  if (n <= 0 || n_books <= 0) return 0;
  const Args a{x, cb, e2, embeds, out, n, d, n_books, v};
  return VARIANTS[pick(n)].run(a, static_cast<cudaStream_t>(stream));
}

// For variant i < min(count, the number of variants): clusters[i] = how
// many of its clusters the device holds at once at depth d. Returns a
// cudaError_t.
extern "C" int rvq_max_active_clusters(int d, int* clusters, int count) {
  for (int i = 0; i < count && i < N_VARIANTS; ++i) {
    const int err = VARIANTS[i].occupancy(d, &clusters[i]);
    if (err != 0) return err;
  }
  return 0;
}

extern "C" int rvq_variant_count() { return N_VARIANTS; }
