// LSTM and GRU time loops for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of mxtpu/ops/pallas_rnn.py:
//   mx_lstm_scan  <- _fwd_call().kernel      (lstm_scan, pallas_rnn.py:34)
//   mx_gru_scan   <- _gru_fwd_call().kernel  (gru_scan,  pallas_rnn.py:98)
// They compute the same functions, not the same blocks: the TPU kernel
// walks a sequential grid over T with h/c in VMEM scratch; here the batch
// rows of the recurrence are independent, so each thread block owns one
// batch row n and loops over t itself, with h (and c) kept in shared
// memory as f32 for all T steps.
//
// Per step, the threads of a block cover the 4H (LSTM) or 3H (GRU) gate
// columns; thread j reads column j of the row-major (H, G) recurrent
// weight, so neighbouring threads read neighbouring addresses.  A
// __syncthreads() separates the h.W product from the pointwise update over
// H, which writes ys[t, n, :] in the input's dtype.  Inputs are f32 or
// bf16; all arithmetic and the carry are f32.
//
// What bounds it on this card: per step every block reads all of Wh
// (H x 4H; 640 KB in f32 at H=200) from L2 and does an N x H by H x 4H
// product spread over N blocks, and the T steps are sequential, so a
// launch costs about T times the latency of one L2-bound row-times-matrix
// pass; with N <= 132 most SMs sit idle.  The DRAM/FLOP bound of the same
// work is far below that.  Sharing Wh across rows (a cluster, or wgmma over
// a tile of rows with Wh resident in shared memory) is left to later work:
// this version is the simple, right one.
//
// The wrapper (mxtpu_torch/ops/rnn_scan.py) checks devices, dtypes,
// shapes and contiguity, allocates every output and passes PyTorch's
// current stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch casts
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// xp (T, N, 4H) gates i,f,g,o; wh (H, 4H); h0/c0 (N, H);
// ys (T, N, H); hT/cT (N, H).  TX: xp/wh/ys type, TS: state type.
template <typename TX, typename TS>
__global__ void lstm_scan_kernel(const TX* __restrict__ xp,
                                 const TX* __restrict__ wh,
                                 const TS* __restrict__ h0,
                                 const TS* __restrict__ c0,
                                 TX* __restrict__ ys, TS* __restrict__ hT,
                                 TS* __restrict__ cT, int T, int N, int H) {
  extern __shared__ float smem[];
  float* h = smem;          // H
  float* c = smem + H;      // H
  float* g = smem + 2 * H;  // 4H
  const int n = blockIdx.x;
  const int G = 4 * H;
  for (int u = threadIdx.x; u < H; u += blockDim.x) {
    h[u] = load(h0, (long)n * H + u);
    c[u] = load(c0, (long)n * H + u);
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const long xrow = ((long)t * N + n) * G;
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) acc = fmaf(h[k], load(wh, (long)k * G + j), acc);
      g[j] = load(xp, xrow + j) + acc;
    }
    __syncthreads();
    const long yrow = ((long)t * N + n) * H;
    for (int u = threadIdx.x; u < H; u += blockDim.x) {
      const float i = sigmoid(g[u]);
      const float f = sigmoid(g[H + u]);
      const float gg = tanhf(g[2 * H + u]);
      const float o = sigmoid(g[3 * H + u]);
      const float cn = f * c[u] + i * gg;
      const float hn = o * tanhf(cn);
      c[u] = cn;
      h[u] = hn;
      store(ys, yrow + u, hn);
    }
    __syncthreads();
  }
  for (int u = threadIdx.x; u < H; u += blockDim.x) {
    store(hT, (long)n * H + u, h[u]);
    store(cT, (long)n * H + u, c[u]);
  }
}

// xp (T, N, 3H) gates r,z,n with the r/z recurrent bias already folded in;
// whrz (H, 2H); whn (H, H); bhn (H); h0 (N, H); ys (T, N, H); hT (N, H).
template <typename TX, typename TS>
__global__ void gru_scan_kernel(const TX* __restrict__ xp,
                                const TX* __restrict__ whrz,
                                const TX* __restrict__ whn,
                                const TX* __restrict__ bhn,
                                const TS* __restrict__ h0,
                                TX* __restrict__ ys, TS* __restrict__ hT,
                                int T, int N, int H) {
  extern __shared__ float smem[];
  float* h = smem;      // H
  float* g = smem + H;  // 3H: r,z pre-activations, then h.Whn + bhn
  const int n = blockIdx.x;
  const int G = 3 * H;
  for (int u = threadIdx.x; u < H; u += blockDim.x) h[u] = load(h0, (long)n * H + u);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const long xrow = ((long)t * N + n) * G;
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc = 0.0f;
      if (j < 2 * H) {
#pragma unroll 4
        for (int k = 0; k < H; ++k) acc = fmaf(h[k], load(whrz, (long)k * 2 * H + j), acc);
        g[j] = load(xp, xrow + j) + acc;
      } else {
        const int jj = j - 2 * H;
#pragma unroll 4
        for (int k = 0; k < H; ++k) acc = fmaf(h[k], load(whn, (long)k * H + jj), acc);
        g[j] = acc + load(bhn, jj);
      }
    }
    __syncthreads();
    const long yrow = ((long)t * N + n) * H;
    for (int u = threadIdx.x; u < H; u += blockDim.x) {
      const float r = sigmoid(g[u]);
      const float z = sigmoid(g[H + u]);
      const float nn = tanhf(load(xp, xrow + 2 * H + u) + r * g[2 * H + u]);
      const float hn = (1.0f - z) * nn + z * h[u];
      h[u] = hn;
      store(ys, yrow + u, hn);
    }
    __syncthreads();
  }
  for (int u = threadIdx.x; u < H; u += blockDim.x) store(hT, (long)n * H + u, h[u]);
}

int block_threads(int G) {
  int th = ((G + 31) / 32) * 32;
  return th > 1024 ? 1024 : th;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename TX, typename TS>
int launch_lstm(const void* xp, const void* wh, const void* h0, const void* c0,
                void* ys, void* hT, void* cT, int T, int N, int H,
                cudaStream_t stream) {
  const size_t smem = (size_t)6 * H * sizeof(float);
  auto kernel = lstm_scan_kernel<TX, TS>;
  if (int e = prepare(kernel, smem)) return e;
  kernel<<<N, block_threads(4 * H), smem, stream>>>(
      (const TX*)xp, (const TX*)wh, (const TS*)h0, (const TS*)c0, (TX*)ys,
      (TS*)hT, (TS*)cT, T, N, H);
  return (int)cudaGetLastError();
}

template <typename TX, typename TS>
int launch_gru(const void* xp, const void* whrz, const void* whn,
               const void* bhn, const void* h0, void* ys, void* hT, int T,
               int N, int H, cudaStream_t stream) {
  const size_t smem = (size_t)4 * H * sizeof(float);
  auto kernel = gru_scan_kernel<TX, TS>;
  if (int e = prepare(kernel, smem)) return e;
  kernel<<<N, block_threads(3 * H), smem, stream>>>(
      (const TX*)xp, (const TX*)whrz, (const TX*)whn, (const TX*)bhn,
      (const TS*)h0, (TX*)ys, (TS*)hT, T, N, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x_bf16: xp/wh/ys are bf16 (else f32); s_bf16: h0/c0/hT/cT are bf16.
int mx_lstm_scan(const void* xp, const void* wh, const void* h0, const void* c0,
                 void* ys, void* hT, void* cT, int T, int N, int H, int x_bf16,
                 int s_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (x_bf16 && s_bf16) return launch_lstm<bf, bf>(xp, wh, h0, c0, ys, hT, cT, T, N, H, s);
  if (x_bf16) return launch_lstm<bf, float>(xp, wh, h0, c0, ys, hT, cT, T, N, H, s);
  if (s_bf16) return launch_lstm<float, bf>(xp, wh, h0, c0, ys, hT, cT, T, N, H, s);
  return launch_lstm<float, float>(xp, wh, h0, c0, ys, hT, cT, T, N, H, s);
}

// x_bf16: xp/whrz/whn/bhn/ys are bf16 (else f32); s_bf16: h0/hT are bf16.
int mx_gru_scan(const void* xp, const void* whrz, const void* whn,
                const void* bhn, const void* h0, void* ys, void* hT, int T,
                int N, int H, int x_bf16, int s_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf;
  if (x_bf16 && s_bf16) return launch_gru<bf, bf>(xp, whrz, whn, bhn, h0, ys, hT, T, N, H, s);
  if (x_bf16) return launch_gru<bf, float>(xp, whrz, whn, bhn, h0, ys, hT, T, N, H, s);
  if (s_bf16) return launch_gru<float, bf>(xp, whrz, whn, bhn, h0, ys, hT, T, N, H, s);
  return launch_gru<float, float>(xp, whrz, whn, bhn, h0, ys, hT, T, N, H, s);
}

}  // extern "C"
