// Flash attention, forward and backward, in float32 on the CUDA cores
// (sm_90a), plain C interface.
//
// Replaces, for float32 inputs, the three Pallas TPU kernels of
// mxtpu/ops/pallas_attention.py:
//   mx_flash_fwd      <- fwd_kernel      (pallas_attention.py:101, call :142)
//   mx_flash_bwd_dq   <- bwd_dq_kernel   (pallas_attention.py:173, call :236)
//   mx_flash_bwd_dkv  <- bwd_dkv_kernel  (pallas_attention.py:199, call :255)
// They compute the same functions, not the same blocks.  The TPU kernels
// walk a grid whose innermost axis runs in order, carrying the running
// max, denominator and accumulators in VMEM scratch from one grid step to
// the next.  Blocks on the card run in no order, so here a loop inside the
// block takes the place of that axis:
//   - fwd and dQ: one block per (b*h, Q tile), looping over K/V tiles up
//     to the causal limit of its last row;
//   - dK/dV: one block per (b*h, K tile), looping over Q tiles from the
//     first row that can see it.
// Under a causal mask the last Q tiles (the first K tiles) do the most
// work, so blocks take them first and the light ones fill in behind.
// This is the flash-attention-2 split the TPU code uses: every output row
// has one owner, so there are no atomics and the results are
// deterministic.
//
// Inside a block, each row (a Q row, or a K row in dK/dV) belongs to a
// group of G = D/16 consecutive lanes; lane g of the group holds dims
// 4*(g + G*c) + e (c < 4, e < 4) of the row's vectors in registers, so the
// group's lanes read neighbouring float4s of a shared-memory row and the
// rest of the warp reads the same addresses (a broadcast).  A dot product
// is 16 FMAs per lane and a shuffle reduction over the group.  The tile
// being streamed (K/V, or Q/dO) sits in shared memory.  All arithmetic is
// f32: m, l, the accumulators, lse and delta.
//
// At D = 16 and 32 (G = 1 or 2) a row would get fewer than four lanes,
// and one lane would walk all of its row's keys (in dK/dV, all of its
// key's queries) in series: at the training slice's shape, two warps on
// an SM.  There a row gets S = 4/G groups instead, and group s takes keys
// (queries) j = s (mod S) of each shared tile with its own partial
// results; at the end the S partials merge with shuffles in a fixed
// order, so the result is still deterministic.  The forward keeps a
// running max and sum a group and merges them as m* = max m_s, l = sum
// l_s e^(m_s - m*), acc likewise; the backward's p = exp(s scale - lse)
// needs no running max, so its partial dQ (dK and dV) just add up.  A
// block there owns 32 rows, so it is 128 threads and a grid has twice
// the blocks.  Shared rows are padded by 8 floats so that the S groups'
// float4 reads fall in different banks.  Rows past T still run the loop
// and the merge (they only skip the store), so the shuffles see whole
// warps.  At D = 64 and 128, S = 1 and each kernel is the plain
// one-group-per-row loop.
//
// Masks follow the Pallas kernels: key j is live for query i iff j <
// kv_len and, when causal, q_off + i >= k_off + j (global positions, from
// the 4-float device vector offs = [q_off, k_off, kv_len, scale], read on
// the card: no host sync).  Masked scores are -1e30 before the running max
// and p is zeroed under the mask, so corr = exp(m_prev - m_new) is 1 while
// both are -1e30, and a row with no live key ends with O = 0 and lse =
// -1e30.  Rows and keys past T are masked here, so the caller needs no
// padding copies.
//
// Which inputs reach this file: float32 only.  bfloat16 runs on the
// tensor cores (wgmma, tiles brought in by TMA) in
// flash_attention_sm90.cu; the wrapper picks the kernel from the dtype,
// and every entry here refuses bf16 (cudaErrorInvalidValue).  float32
// does not go through the tensor cores: TF32 would not hold the f32 plain
// version's 1e-5.
//
// What bounds it on this card: the products.  Per live (query, key) pair
// the forward does 4*D flops, dQ 6*D and dK/dV 8*D, all as f32 FMAs on the
// CUDA cores (67 TFLOP/s); each FMA also needs a shared-memory operand,
// which a float4 broadcast spreads over four.  The inputs are read once
// per tile pair from L2.
//
// The wrapper (mxtpu_torch/ops/flash_attention.py) checks devices, dtypes,
// shapes and contiguity, allocates every output and passes PyTorch's
// current stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;  // _NEG of the Pallas kernels
constexpr int kDT = 16;         // dims of a row one lane holds
constexpr int kNC = kDT / 4;    // float4 chunks of them
constexpr int kCH = 8;          // keys (queries) a group scores per step of the loop

// keys (queries) of a shared tile: 4096 f32 at most, 64 at most
__host__ __device__ constexpr int tile_rows(int D) {
  return (4096 / D) < 64 ? (4096 / D) : 64;
}

// a block's shape at head dim D, the same for the forward, dQ and dK/dV
// (see the header)
template <int D>
struct Shape {
  static constexpr int G = D / kDT;              // lanes holding a row's dims
  static constexpr int S = G < 4 ? 4 / G : 1;    // groups splitting a row's keys (queries)
  static constexpr int kRows = S > 1 ? 32 : 64;  // rows a block owns (Q rows, or K rows)
  static constexpr int kThreads = kRows * G * S;
  static constexpr int BT = tile_rows(D);        // keys (queries) of a shared tile
  static constexpr int kLd = D + (S > 1 ? 8 : 0);  // floats between shared rows
  // group s takes rows j0 + s + S*jj (jj < kCH) of a tile, j0 a multiple
  // of kCH*S: they stay inside it
  static_assert(BT % (kCH * S) == 0, "a group's rows must stay inside the tile");
};

// dim of chunk c, element e, for lane g of a group of G
template <int G>
__device__ __forceinline__ int dim_of(int g, int c) { return 4 * (g + G * c); }

// sum over the G lanes of a group (consecutive lanes of one warp)
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a row's slice in registers, from global memory (zeros past the end)
template <int G>
__device__ __forceinline__ void load_row(float (&r)[kNC][4], const float* base, long row,
                                         bool valid, int D, int g) {
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[c][e] = valid ? base[row * D + dim_of<G>(g, c) + e] : 0.0f;
}

template <int G>
__device__ __forceinline__ void store_row(float* base, long row, const float (&r)[kNC][4],
                                          float div, int D, int g) {
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) base[row * D + dim_of<G>(g, c) + e] = r[c][e] / div;
}

// sum the S groups' partial results of a row (lanes G, 2G, ... apart),
// in the same order on every run
template <int G, int S>
__device__ __forceinline__ void sum_groups(float (&acc)[kNC][4]) {
#pragma unroll
  for (int off = G; off < G * S; off <<= 1)
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] += __shfl_xor_sync(0xffffffffu, acc[c][e], off);
}

// partial dot product of a register slice with row j of a shared tile
// whose rows are ld floats apart
template <int G>
__device__ __forceinline__ float dot_smem(const float (&r)[kNC][4], const float* tile,
                                          int j, int ld, int g) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    const float4 t = *reinterpret_cast<const float4*>(tile + j * ld + dim_of<G>(g, c));
    acc = fmaf(r[c][0], t.x, acc);
    acc = fmaf(r[c][1], t.y, acc);
    acc = fmaf(r[c][2], t.z, acc);
    acc = fmaf(r[c][3], t.w, acc);
  }
  return acc;
}

// acc += w * row j of a shared tile
template <int G>
__device__ __forceinline__ void axpy_smem(float (&acc)[kNC][4], float w, const float* tile,
                                          int j, int ld, int g) {
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    const float4 t = *reinterpret_cast<const float4*>(tile + j * ld + dim_of<G>(g, c));
    acc[c][0] = fmaf(w, t.x, acc[c][0]);
    acc[c][1] = fmaf(w, t.y, acc[c][1]);
    acc[c][2] = fmaf(w, t.z, acc[c][2]);
    acc[c][3] = fmaf(w, t.w, acc[c][3]);
  }
}

// rows [row0, row0 + N) of two (T, D) matrices a and b into shared (N,
// LD) tiles, zeros past T.  All THREADS threads of the block take part,
// and each issues every one of its loads before its first store, so a
// pair of tiles costs one trip to L2, not one per element.
template <int N, int D, int LD, int THREADS>
__device__ __forceinline__ void load_tiles(float* ta, const float* a, float* tb, const float* b,
                                           int row0, int T) {
  constexpr int kPer = (N * D + THREADS - 1) / THREADS;
  float ra[kPer], rb[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * THREADS, r = i / D;
    const bool ok = i < N * D && row0 + r < T;
    const long at = (long)(row0 + r) * D + i % D;
    ra[u] = ok ? a[at] : 0.0f;
    rb[u] = ok ? b[at] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i < N * D) {
      ta[(i / D) * LD + i % D] = ra[u];
      tb[(i / D) * LD + i % D] = rb[u];
    }
  }
}

struct Offs {
  int q_off, k_off, kv_len;
  float scale;
};

__device__ __forceinline__ Offs read_offs(const float* offs, int Tk) {
  Offs o;
  o.q_off = (int)offs[0];
  o.k_off = (int)offs[1];
  o.kv_len = min((int)offs[2], Tk);
  o.scale = offs[3];
  return o;
}

// Number of keys a tile of `rows` Q rows from q0 must visit: up to the
// causal limit of its last row (block-uniform, so every lane runs the
// same loop and the shuffles see whole warps).
__device__ __forceinline__ int key_end(const Offs& o, int q0, int rows, int causal) {
  if (!causal) return o.kv_len;
  const int last = o.q_off + q0 + rows - 1 - o.k_off + 1;  // keys j < last
  return max(0, min(o.kv_len, last));
}

// ---------------------------------------------------------------------------
// forward: O and lse for one (b*h, Q tile)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ offs,
                 float* __restrict__ o, float* __restrict__ lse, int BH, int Tq, int Tk,
                 int n_tiles, int causal) {
  using F = Shape<D>;
  constexpr int G = F::G, S = F::S, R = F::kRows, BK = F::BT, LD = F::kLd;
  __shared__ __align__(16) float ks[BK * LD];
  __shared__ __align__(16) float vs[BK * LD];
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - blockIdx.x / BH) * R;  // heaviest tiles first
  const int r = threadIdx.x / (G * S), s = (threadIdx.x / G) % S, g = threadIdx.x % G;
  const int qi = q0 + r;
  const Offs of = read_offs(offs, Tk);
  const float* qb = q + (long)bh * Tq * D;
  const float* kb = k + (long)bh * Tk * D;
  const float* vb = v + (long)bh * Tk * D;

  float qr[kNC][4], acc[kNC][4];
  load_row<G>(qr, qb, qi, qi < Tq, D, g);
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  float m = kNeg, l = 0.0f;  // over the keys of this lane's group only
  const int q_glob = of.q_off + qi;
  const int kend = key_end(of, q0, R, causal);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_tiles<BK, D, LD, F::kThreads>(ks, kb, vs, vb, k0, Tk);
    __syncthreads();
    const int nk = min(BK, kend - k0);
    // group s takes keys j0 + s + S*jj of the tile
    for (int j0 = 0; j0 < nk; j0 += kCH * S) {
      float sc[kCH];
      bool live[kCH];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kCH; ++jj) {
        const int jt = j0 + s + S * jj;
        const int j = k0 + jt;
        const float d = group_sum<G>(dot_smem<G>(qr, ks, jt, LD, g));
        live[jj] = j < of.kv_len && (!causal || q_glob >= of.k_off + j);
        sc[jj] = live[jj] ? d * of.scale : kNeg;
        m_new = fmaxf(m_new, sc[jj]);
      }
      const float corr = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < kNC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
#pragma unroll
      for (int jj = 0; jj < kCH; ++jj) {
        const float p = live[jj] ? expf(sc[jj] - m_new) : 0.0f;
        psum += p;
        axpy_smem<G>(acc, p, vs, j0 + s + S * jj, LD, g);
      }
      l = l * corr + psum;
      m = m_new;
    }
  }
  if constexpr (S > 1) {
    // merge the S groups of the row: lanes G, 2G, ... apart
    float mm = m;
#pragma unroll
    for (int off = G; off < G * S; off <<= 1) mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    const float w = expf(m - mm);  // 0 for a group that saw no live key, 1 if none did
    l *= w;
#pragma unroll
    for (int c = 0; c < kNC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= w;
#pragma unroll
    for (int off = G; off < G * S; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    sum_groups<G, S>(acc);
    m = mm;
  }
  if (qi < Tq && s == 0) {
    const float l_safe = l == 0.0f ? 1.0f : l;
    store_row<G>(o + (long)bh * Tq * D, qi, acc, l_safe, D, g);
    if (g == 0) lse[(long)bh * Tq + qi] = l == 0.0f ? kNeg : m + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ for one (b*h, Q tile):
//   dQ = sum_k ds K,  ds = p (dO.V^T - delta) scale,  p = exp(s scale - lse)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ offs, float* __restrict__ dq, int BH, int Tq,
                    int Tk, int n_tiles, int causal) {
  using F = Shape<D>;
  constexpr int G = F::G, S = F::S, R = F::kRows, BK = F::BT, LD = F::kLd;
  __shared__ __align__(16) float ks[BK * LD];
  __shared__ __align__(16) float vs[BK * LD];
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - blockIdx.x / BH) * R;  // heaviest tiles first
  const int r = threadIdx.x / (G * S), s = (threadIdx.x / G) % S, g = threadIdx.x % G;
  const int qi = q0 + r;
  const bool valid = qi < Tq;
  const Offs of = read_offs(offs, Tk);
  const float* kb = k + (long)bh * Tk * D;
  const float* vb = v + (long)bh * Tk * D;

  float qr[kNC][4], dor[kNC][4], acc[kNC][4];  // acc: over this group's keys
  load_row<G>(qr, q + (long)bh * Tq * D, qi, valid, D, g);
  load_row<G>(dor, dout + (long)bh * Tq * D, qi, valid, D, g);
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;
  const float lse_i = valid ? lse[(long)bh * Tq + qi] : 0.0f;
  const float delta_i = valid ? delta[(long)bh * Tq + qi] : 0.0f;
  const int q_glob = of.q_off + qi;
  const int kend = key_end(of, q0, R, causal);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_tiles<BK, D, LD, F::kThreads>(ks, kb, vs, vb, k0, Tk);
    __syncthreads();
    const int nk = min(BK, kend - k0);
    // group s takes keys j0 + s + S*jj of the tile
    for (int j0 = 0; j0 < nk; j0 += kCH * S) {
#pragma unroll
      for (int jj = 0; jj < kCH; ++jj) {
        const int jt = j0 + s + S * jj;
        const int j = k0 + jt;
        const float sc = group_sum<G>(dot_smem<G>(qr, ks, jt, LD, g));
        const float dp = group_sum<G>(dot_smem<G>(dor, vs, jt, LD, g));
        const bool live = j < of.kv_len && (!causal || q_glob >= of.k_off + j);
        const float p = live ? expf(sc * of.scale - lse_i) : 0.0f;
        axpy_smem<G>(acc, p * (dp - delta_i) * of.scale, ks, jt, LD, g);
      }
    }
  }
  sum_groups<G, S>(acc);  // nothing to merge at S = 1
  if (valid && s == 0) store_row<G>(dq + (long)bh * Tq * D, qi, acc, 1.0f, D, g);
}

// ---------------------------------------------------------------------------
// backward, dK and dV for one (b*h, K tile):
//   dV = sum_q p^T dO,  dK = sum_q ds^T Q
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ offs, float* __restrict__ dk,
                     float* __restrict__ dv, int BH, int Tq, int Tk, int causal) {
  using F = Shape<D>;
  constexpr int G = F::G, S = F::S, R = F::kRows, BQ = F::BT, LD = F::kLd;
  __shared__ __align__(16) float qs[BQ * LD];
  __shared__ __align__(16) float dos[BQ * LD];
  __shared__ float lses[BQ];
  __shared__ float deltas[BQ];
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * R;  // heaviest tiles first: the first keys
  const int r = threadIdx.x / (G * S), s = (threadIdx.x / G) % S, g = threadIdx.x % G;
  const int kj = k0 + r;
  const Offs of = read_offs(offs, Tk);
  const bool valid = kj < Tk;
  const bool key_live = kj < of.kv_len;
  const float* qb = q + (long)bh * Tq * D;
  const float* db = dout + (long)bh * Tq * D;
  const float* lb = lse + (long)bh * Tq;
  const float* eb = delta + (long)bh * Tq;

  float kr[kNC][4], vr[kNC][4], dka[kNC][4], dva[kNC][4];  // over this group's queries
  load_row<G>(kr, k + (long)bh * Tk * D, kj, valid, D, g);
  load_row<G>(vr, v + (long)bh * Tk * D, kj, valid, D, g);
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[c][e] = dva[c][e] = 0.0f;
  const int k_glob = of.k_off + kj;
  // first query row that can see the tile's first key (block-uniform)
  const int qstart = causal ? max(0, min(Tq, of.k_off + k0 - of.q_off)) : 0;
  const int qstart_tile = qstart - qstart % BQ;

  for (int i0 = qstart_tile; i0 < Tq; i0 += BQ) {
    __syncthreads();
    load_tiles<BQ, D, LD, F::kThreads>(qs, qb, dos, db, i0, Tq);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      lses[i] = i0 + i < Tq ? lb[i0 + i] : 0.0f;
      deltas[i] = i0 + i < Tq ? eb[i0 + i] : 0.0f;
    }
    __syncthreads();
    const int nq = min(BQ, Tq - i0);
    // group s takes queries ii0 + s + S*ii of the tile; those past Tq
    // (zero-filled lse and delta) are masked
    for (int ii0 = 0; ii0 < nq; ii0 += kCH * S) {
#pragma unroll
      for (int ii = 0; ii < kCH; ++ii) {
        const int it = ii0 + s + S * ii;
        const int i = i0 + it;
        const float sc = group_sum<G>(dot_smem<G>(kr, qs, it, LD, g));
        const float dp = group_sum<G>(dot_smem<G>(vr, dos, it, LD, g));
        const bool live = key_live && i < Tq && (!causal || of.q_off + i >= k_glob);
        const float p = live ? expf(sc * of.scale - lses[it]) : 0.0f;
        axpy_smem<G>(dva, p, dos, it, LD, g);
        axpy_smem<G>(dka, p * (dp - deltas[it]) * of.scale, qs, it, LD, g);
      }
    }
  }
  sum_groups<G, S>(dka);
  sum_groups<G, S>(dva);
  if (valid && s == 0) {
    store_row<G>(dk + (long)bh * Tk * D, kj, dka, 1.0f, D, g);
    store_row<G>(dv + (long)bh * Tk * D, kj, dva, 1.0f, D, g);
  }
}

int tiles(int T, int rows) { return (T + rows - 1) / rows; }

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* offs, void* o,
               float* lse, int BH, int Tq, int Tk, int causal, cudaStream_t s) {
  const int nt = tiles(Tq, Shape<D>::kRows);
  flash_fwd_kernel<D><<<BH * nt, Shape<D>::kThreads, 0, s>>>(
      (const float*)q, (const float*)k, (const float*)v, offs, (float*)o, lse, BH, Tq, Tk,
      nt, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const float* offs, void* dq, int BH, int Tq, int Tk,
              int causal, cudaStream_t s) {
  const int nt = tiles(Tq, Shape<D>::kRows);
  flash_bwd_dq_kernel<D><<<BH * nt, Shape<D>::kThreads, 0, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, offs,
      (float*)dq, BH, Tq, Tk, nt, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const float* offs, void* dk, void* dv, int BH, int Tq,
               int Tk, int causal, cudaStream_t s) {
  const int nt = tiles(Tk, Shape<D>::kRows);
  flash_bwd_dkv_kernel<D><<<BH * nt, Shape<D>::kThreads, 0, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta, offs,
      (float*)dk, (float*)dv, BH, Tq, Tk, causal);
  return (int)cudaGetLastError();
}

// one switch over the head dim, float32 only: bf16 (BF16 != 0) runs in
// flash_attention_sm90.cu and is refused here
#define MX_DISPATCH_F32(BF16, D, CALL)  \
  do {                                  \
    if (!(BF16)) {                      \
      switch (D) {                      \
        case 16: return CALL(16);       \
        case 32: return CALL(32);       \
        case 64: return CALL(64);       \
        case 128: return CALL(128);     \
      }                                 \
    }                                   \
    return (int)cudaErrorInvalidValue;  \
  } while (0)

}  // namespace

extern "C" {

// q (BH, Tq, D), k/v (BH, Tk, D), f32 (bf16 is refused: see above); offs
// 4 f32 on the card; writes o (BH, Tq, D) f32 and lse (BH, Tq) f32.
int mx_flash_fwd(const void* q, const void* k, const void* v, const void* offs, void* o,
                 void* lse, int BH, int Tq, int Tk, int D, int causal, int bf16,
                 void* stream) {
#define MX_FWD(DD) \
  launch_fwd<DD>(q, k, v, (const float*)offs, o, (float*)lse, BH, Tq, Tk, causal, (cudaStream_t)stream)
  MX_DISPATCH_F32(bf16, D, MX_FWD);
#undef MX_FWD
}

// as mx_flash_fwd plus dout (BH, Tq, D) f32 and lse/delta (BH, Tq) f32;
// writes dq (BH, Tq, D) f32.
int mx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* offs, void* dq, int BH,
                    int Tq, int Tk, int D, int causal, int bf16, void* stream) {
#define MX_DQ(DD)                                                                           \
  launch_dq<DD>(q, k, v, dout, (const float*)lse, (const float*)delta, (const float*)offs, \
                dq, BH, Tq, Tk, causal, (cudaStream_t)stream)
  MX_DISPATCH_F32(bf16, D, MX_DQ);
#undef MX_DQ
}

// as mx_flash_bwd_dq; writes dk and dv (BH, Tk, D) f32.
int mx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* offs, void* dk, void* dv,
                     int BH, int Tq, int Tk, int D, int causal, int bf16, void* stream) {
#define MX_DKV(DD)                                                                           \
  launch_dkv<DD>(q, k, v, dout, (const float*)lse, (const float*)delta, (const float*)offs, \
                 dk, dv, BH, Tq, Tk, causal, (cudaStream_t)stream)
  MX_DISPATCH_F32(bf16, D, MX_DKV);
#undef MX_DKV
}

}  // extern "C"
