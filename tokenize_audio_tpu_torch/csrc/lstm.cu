// EnCodec's two-layer LSTM over a batch's frames, with its input added back,
// as one persistent kernel for Hopper.
//
// Replaces: no TPU kernel (the JAX package has no EnCodec). It replaces
// cuDNN's LSTM (torch.lstm), which launched a small matrix product and a
// cell kernel for every frame and layer. For the 2-layer LSTM of width
// H = 512 of facebook/encodec_24khz, from a zero state, in IEEE float32:
//   layer 0: gates = gx[t] + W_hh0 h0[t-1]
//            (gx = x W_ih0^T + b_ih0 + b_hh0: one matrix product before the
//            launch, ops/cuda/lstm.py)
//   layer 1: gates = W_ih1 h0[t] + W_hh1 h1[t-1] + (b_ih1 + b_hh1)
//   i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//   c = f c + i g;  h = o tanh(c)
// and out[b, :, t] = h1[t] + x[b, :, t], in the (B, C, T) layout the final
// conv reads. Every frame of every row is stepped, padded ones too.
//
// What bounds it on this card: the frames are sequential. A frame of both
// layers is 4 * H * 3H FMAs a row (W_hh0, W_ih1, W_hh1), about 0.14 us a row
// spread over the card's FP32 lanes, so at the 1-24 rows of the engine's
// batches a frame is bound by latency: the exchange of each layer's h
// between SMs through L2 and a grid-wide barrier. With more rows, every
// block reading every row's h from L2 (4 KB a row, the same lines on all
// SMs) and the products' shared-memory reads of it bound it, at ~2.5x the
// FMA time at 128 rows. (IEEE float32 is the contract: no TF32, no tensor
// cores.)
//
// What the design does about that:
// - One block per SM, 128 blocks, all resident at once (a cooperative
//   launch, which refuses a grid the card cannot hold, so the barrier can
//   never wait on a block that is not running). Block j owns hidden units
//   4j..4j+3 of both layers, all four gates of each, so the cell update
//   stays inside the block; each block does the same work (16 gate rows of
//   512 inputs for layer 0, 16 of 1024 for layer 1).
// - The 12 MB of recurrent weights (W_hh0, W_ih1, W_hh1) stay in registers
//   for the whole launch, 48 floats a thread, read once in the packed
//   layout ops/cuda/lstm.py::pack_weights makes. A warp covers 32 inputs of
//   h for all 32 of its block's gate rows; a lane holds 8 inputs x 4 gate
//   rows (two of each layer), so one shared-memory load of h feeds 4-6 FMAs.
//   The 4 lanes of a row group reduce by a transposing shuffle (3 shuffles
//   leave one finished sum a lane), the 16 warps through shared memory.
// - The layers are pipelined by frame: iteration s runs layer 0 at frame s
//   and layer 1 at frame s - 1, which read the same h0[s - 1], so T + 1
//   iterations take one grid barrier each (a release add and acquire loads
//   on a counter in device memory that only grows; no sequentially
//   consistent fence). Each layer's h is exchanged through L2 (stores, then
//   16-byte cp.async copies that bypass L1, all in flight at once),
//   double-buffered by the frame's parity.
// - The cell runs a lane a gate row: the 16 warps' partial sums added as a
//   tree, the four gates' activations in four lanes at once, met by
//   shuffles in the lane that updates the unit's c (kept in shared memory)
//   and writes its h.
// - What an iteration reads from device memory besides h -- layer 0's
//   input gates and the inputs layer 1 adds back -- is copied into shared
//   memory by cp.async one iteration ahead, in flight through the barrier.
// - The row count sets the tiling: up to 24 rows are staged and reduced at
//   once, more in passes of 24, each warp looping over the rows with its
//   weights in registers, so a few rows cost little more than the exchange.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int H = 512;               // hidden width
constexpr int UNITS = 4;             // units of each layer a block owns
constexpr int BLOCKS = H / UNITS;    // 128 co-resident blocks
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;  // 16
constexpr int KW = H / WARPS;        // 32 inputs of h a warp sums over
constexpr int KL = KW / 4;           // 8 a lane
constexpr int GATES = 4 * UNITS;     // 16 gate rows of one layer in a block
constexpr int NW = 6 * KL;           // 48 weights a thread
constexpr int RC = 24;               // batch rows staged at once
constexpr int RED = WARPS + 1;       // padded stride of the warps' partial sums
constexpr size_t SMEM_LIMIT = 232448;

static_assert(THREADS / 32 * KW == H && KL * 4 == KW, "a warp covers KW inputs, a lane KL");
static_assert(WARPS * 32 * NW == 4 * UNITS * 3 * H, "the threads hold every weight once");

struct Args {
  const float* gx;   // (T, B, 4H): layer 0's input gates, packed gate order
  const float* x;    // (B, H, T)
  const float* rec;  // (BLOCKS, NW, THREADS): packed W_hh0, W_ih1, W_hh1
  const float* b1;   // (4H,): b_ih1 + b_hh1, packed gate order
  float* out;        // (B, H, T)
  float* hbuf;       // (2 layers, 2 parities, B, H)
  unsigned* count;   // the grid barrier's arrivals, zero at the launch
  int b, t;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's latest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every write before it, by any thread of the grid, is visible to every
// read after it: the block's writes reach thread 0 through the block
// barrier, and its release add publishes them; the acquire load that sees
// every block's add makes theirs visible, to all threads through the
// second block barrier. The counter only grows: the n-th barrier of a
// launch waits for n * BLOCKS arrivals.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
    while (load_acquire(count) < target) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

size_t smem_bytes(int b) {
  const int rc = b < RC ? b : RC;
  return sizeof(float) * (static_cast<size_t>(b) * (2 * GATES + 4 * UNITS) + GATES +
                          static_cast<size_t>(rc) * (2 * H + 2 * GATES * RED));
}

__global__ void __launch_bounds__(THREADS, 1) lstm2_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int B = a.b, T = a.t;
  const int rc = B < RC ? B : RC;
  float* const gxs = reinterpret_cast<float*>(smem4);  // [2 parities][B][GATES]
  float* const xs = gxs + 2 * B * GATES;               // [2 parities][B][UNITS]
  float* const cs = xs + 2 * B * UNITS;                // [2 layers][B][UNITS]
  float* const b1s = cs + 2 * B * UNITS;               // [GATES]
  float* const hs = b1s + GATES;                       // [rc][h0 | h1], 16-byte aligned
  float* const red = hs + rc * 2 * H;                  // [rc][2 GATES][RED]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 2, kg = lane & 3;  // row group, input group
  const int blk = blockIdx.x, unit0 = blk * UNITS;
  const int k0 = warp * KW + kg * KL;       // this lane's first input of h

  // w[8 p + j] is row (rg + 8 (p & 1)) of the block's gate rows of
  // W_hh0 (p = 0, 1), W_ih1 (p = 2, 3) or W_hh1 (p = 4, 5), input k0 + j
  float w[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) w[j] = a.rec[(static_cast<size_t>(blk) * NW + j) * THREADS + tid];
  for (int i = tid; i < 2 * B * UNITS; i += THREADS) cs[i] = 0.0f;
  if (tid < GATES) b1s[tid] = a.b1[blk * GATES + tid];

  // What iteration s reads from device memory, into the buffers of its
  // parity: layer 0's input gates of frame s, and the inputs of frame s - 1
  // that layer 1's output adds back.
  auto prefetch = [&](int s) {
    const int p = s & 1;
    if (s < T)
      for (int i = tid; i < B * 4; i += THREADS) {
        const int r = i >> 2, q = (i & 3) * 4;
        cp_async16(gxs + (p * B + r) * GATES + q,
                   a.gx + (static_cast<size_t>(s) * B + r) * (4 * H) + blk * GATES + q);
      }
    if (s >= 1)
      for (int i = tid; i < B * UNITS; i += THREADS) {
        const int r = i / UNITS, u = i % UNITS;
        cp_async4(xs + (p * B + r) * UNITS + u,
                  a.x + (static_cast<size_t>(r) * H + unit0 + u) * T + (s - 1));
      }
  };
  prefetch(0);
  cp_async_commit();

  float* const h0buf = a.hbuf;                                // [2][B][H]
  float* const h1buf = a.hbuf + 2 * static_cast<size_t>(B) * H;
  for (int s = 0; s <= T; ++s) {
    const int p = s & 1;
    const float* h0prev = s >= 1 ? h0buf + static_cast<size_t>((s - 1) & 1) * B * H : nullptr;
    const float* h1prev = s >= 2 ? h1buf + static_cast<size_t>((s - 2) & 1) * B * H : nullptr;
    for (int r0 = 0; r0 < B; r0 += rc) {
      const int n = B - r0 < rc ? B - r0 : rc;
      __syncthreads();  // the last pass is done with hs, red and gs
      // h0[s - 1] and h1[s - 2] of these rows, copied from L2 all at once;
      // zero before frame 0
      for (int i = tid; i < n * (2 * H / 4); i += THREADS) {
        const int rr = i / (2 * H / 4), c4 = i % (2 * H / 4);
        const int layer = c4 >= H / 4;
        const float* src = layer ? h1prev : h0prev;
        if (src != nullptr)
          cp_async16(hs + 4 * i, src + static_cast<size_t>(r0 + rr) * H + 4 * (c4 - layer * (H / 4)));
        else
          reinterpret_cast<float4*>(hs)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      cp_async_commit();
      if (r0 == 0 && s < T) {
        // the next iteration's reads go out behind these rows', and stay
        // in flight through this iteration
        prefetch(s + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      for (int rr = 0; rr < n; ++rr) {
        const float4* hp = reinterpret_cast<const float4*>(hs + rr * 2 * H + k0);
        const float4 a0 = hp[0], a1 = hp[1], c0 = hp[H / 4], c1 = hp[H / 4 + 1];
        const float h0v[KL] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float h1v[KL] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        // layer 0 rows rg, rg + 8; layer 1 rows rg, rg + 8
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < KL; ++j) {
          acc[0] = fmaf(w[j], h0v[j], acc[0]);
          acc[1] = fmaf(w[KL + j], h0v[j], acc[1]);
          acc[2] = fmaf(w[2 * KL + j], h0v[j], acc[2]);
          acc[3] = fmaf(w[3 * KL + j], h0v[j], acc[3]);
        }
#pragma unroll
        for (int j = 0; j < KL; ++j) {
          acc[2] = fmaf(w[4 * KL + j], h1v[j], acc[2]);
          acc[3] = fmaf(w[5 * KL + j], h1v[j], acc[3]);
        }
        // sum over the 4 input groups, transposing: after the xor-1 step a
        // lane keeps one layer's two rows, after the xor-2 step one row
        const bool odd = kg & 1, high = kg & 2;
        float keep0 = odd ? acc[2] : acc[0], keep1 = odd ? acc[3] : acc[1];
        keep0 += __shfl_xor_sync(0xffffffffu, odd ? acc[0] : acc[2], 1);
        keep1 += __shfl_xor_sync(0xffffffffu, odd ? acc[1] : acc[3], 1);
        float sum = high ? keep1 : keep0;
        sum += __shfl_xor_sync(0xffffffffu, high ? keep0 : keep1, 2);
        const int g = (odd ? GATES : 0) + rg + (high ? 8 : 0);
        red[(rr * 2 * GATES + g) * RED + warp] = sum;
      }
      __syncthreads();
      // the cell, a lane a gate row: the warps' partial sums and the input
      // part make its pre-activation; the four gates of a unit, 4 lanes
      // apart, meet in the input gate's lane, which updates c and writes h.
      // n * 2 GATES is a whole number of warps.
      for (int i = tid; i < n * 2 * GATES; i += THREADS) {
        const int rr = i / (2 * GATES), lr = i % GATES, layer = (i / GATES) & 1;
        const int r = r0 + rr, gate = lr / UNITS, u = lr % UNITS;
        const float* pr = red + i * RED;
        float even = 0.0f, odd = 0.0f;  // two chains, 8 adds deep
#pragma unroll
        for (int k = 0; k < WARPS; k += 2) {
          even += pr[k];
          odd += pr[k + 1];
        }
        const float v = (layer == 0 ? gxs[(p * B + r) * GATES + lr] : b1s[lr]) + (even + odd);
        const float act = gate == 2 ? tanhf(v) : sigmoid(v);
        const float fg = __shfl_down_sync(0xffffffffu, act, UNITS);
        const float gg = __shfl_down_sync(0xffffffffu, act, 2 * UNITS);
        const float og = __shfl_down_sync(0xffffffffu, act, 3 * UNITS);
        if (gate != 0 || (layer == 0 ? s >= T : s < 1)) continue;
        float* const c = cs + (layer * B + r) * UNITS + u;
        const float cn = fg * *c + act * gg;
        *c = cn;
        const float h = og * tanhf(cn);
        if (layer == 0) {
          h0buf[(static_cast<size_t>(p) * B + r) * H + unit0 + u] = h;
        } else {
          const int f = s - 1;
          h1buf[(static_cast<size_t>(f & 1) * B + r) * H + unit0 + u] = h;
          a.out[(static_cast<size_t>(r) * H + unit0 + u) * T + f] = h + xs[(p * B + r) * UNITS + u];
        }
      }
    }
    // the prefetch may still be in flight: the next iteration's first wait
    // covers it
    if (s < T) grid_barrier(a.count, static_cast<unsigned>(BLOCKS) * static_cast<unsigned>(s + 1));
  }
}

}  // namespace

// out (B, H, T) = LSTM(x) + x for x (B, H, T), given gx (T, B, 4H) = x's
// layer-0 input gates with both biases, in the packed gate order; rec and
// b1 from ops/cuda/lstm.py::pack_weights; hbuf scratch of 4 * B * H floats
// and count of one unsigned. Queues a memset of count and one cooperative
// launch on ``stream``. Returns a cudaError_t (0 on success).
extern "C" int lstm2_launch(const float* gx, const float* x, const float* rec, const float* b1,
                            float* out, float* hbuf, unsigned* count, int b, int t, void* stream) {
  if (b <= 0 || t <= 0) return 0;
  const size_t smem = smem_bytes(b);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lstm2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(count, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  Args a{gx, x, rec, b1, out, hbuf, count, b, t};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lstm2_kernel), dim3(BLOCKS),
                                    dim3(THREADS), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

