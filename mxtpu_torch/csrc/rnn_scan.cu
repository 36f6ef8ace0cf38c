// LSTM and GRU time loops for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of mxtpu/ops/pallas_rnn.py:
//   mx_lstm_scan  <- _fwd_call().kernel      (lstm_scan, pallas_rnn.py:34)
//   mx_gru_scan   <- _gru_fwd_call().kernel  (gru_scan,  pallas_rnn.py:98)
// They compute the same functions, not the same blocks: the TPU kernel
// walks a sequential grid over T with h/c in VMEM scratch; here a thread
// block cluster loops over t itself.
//
// What bounds the work: a step is an (N x H).(H x 4H) product (3H for the
// GRU) and a pointwise update, and the T steps run in order, so a launch
// costs T times the latency of one step; the DRAM/FLOP bound lies far
// below that. The design cuts the step's latency:
//
// - A cluster of C CTAs (8, or 16 as a non-portable size) owns R <= 4
//   batch rows; the grid has ceil(N/R) clusters. CTA `rank` owns a ragged
//   slice of the hidden units [u0, u0 + nu) (unit_slice) and their gate
//   columns g*H + u, so c, the pointwise update and the writes of ys stay
//   inside the CTA. The GRU's columns are r, z (whrz), n (whn), plus a
//   fourth slot that carries x_proj's n part, so both kernels share one
//   layout of 4 slots a unit.
// - Resident mode: the CTA's weight slice sits in shared memory for all T
//   steps, in the input's dtype, as [k/4][column][k%4], loaded once a
//   launch; its column count (col_stride) is odd, so the 8 lanes of a
//   unit, which read 8 consecutive k-quads of one column, hit distinct
//   banks. Streamed mode (the slice does not fit; chosen from the shape by
//   the wrapper's plan, scan_plan in ops/rnn_scan.py) reads the same slice
//   from global memory each step: 1/C of the weight a CTA.
// - A unit owns SPLIT = 8 lanes of one warp: lane s sums the k-quads
//   q = s, s + 8, ... of all four slots for the R rows, so one load of h
//   serves four columns. A transposed shuffle reduction in a fixed order
//   leaves slot g's total in lanes 2g and 2g + 1 (two calls give the same
//   bits); lane r < R gathers row r's four slots and updates it. No
//   __syncthreads inside the product and update.
// - h moves through distributed shared memory: every CTA keeps all H
//   units of h for its R rows in f32, double-buffered by step parity.
//   After its update a unit's lanes send its R values into every peer's
//   next buffer with st.async, each store completing its bytes on the
//   peer's mbarrier of that buffer; a CTA waits on its own mbarrier for
//   all R*H values of the next step. This takes no cluster barrier a step:
//   after plain remote stores, barrier.cluster.arrive.release waits for
//   the stores to be acknowledged, which on the card cost more of a step
//   than anything but the product. The next step's x_proj values are
//   loaded into registers before the current step's product, so their
//   latency hides behind it.
// - The product runs on the CUDA cores in f32 (R rows are far below a
//   wgmma tile, and the f32 path would mean TF32 on the tensor cores).
//   Inputs are f32 or bf16; all arithmetic and the carry are f32.
//
// The wrapper (mxtpu_torch/ops/rnn_scan.py) plans the launch (cluster,
// rows, mode, threads, shared memory, column stride), checks devices,
// dtypes, shapes and contiguity, allocates every output and passes
// PyTorch's current stream; each entry returns the launch's cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

// four consecutive k of one column from the resident slice
__device__ __forceinline__ float4 load4(const float* w, int i) {
  return reinterpret_cast<const float4*>(w)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* w, int i) {
  const uint2 v = reinterpret_cast<const uint2*>(w)[i];
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

// four consecutive k of one column into the resident slice
__device__ __forceinline__ void store4(float* w, int i, const float* v) {
  reinterpret_cast<float4*>(w)[i] = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* w, int i,
                                       const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  reinterpret_cast<uint2*>(w)[i] = u;
}

constexpr int SPLIT = 8;  // lanes a unit; lane s sums k-quads q = s mod SPLIT

// shared-memory address of a local pointer, and the same offset in the
// shared memory of cluster CTA `rank`
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned peer_u32(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// a 4-byte store into a peer's shared memory that completes its bytes
// on the peer's mbarrier (no fence: the mbarrier tells the reader)
__device__ __forceinline__ void store_to_peer(unsigned addr, float v,
                                              unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

struct Geometry {
  int T, N, H;
  int C;           // CTAs a cluster
  int resident;    // 1: weight slice in shared memory; 0: streamed
  int col_stride;  // columns a k-quad row of the resident slice holds
};

// unit slice of CTA `rank`: the first H % C CTAs take one unit more
__device__ __forceinline__ void unit_slice(int rank, int H, int C, int& u0,
                                           int& nu) {
  const int base = H / C, extra = H % C;
  u0 = rank * base + min(rank, extra);
  nu = base + (rank < extra ? 1 : 0);
}

// Weight column `slot` of unit u at row k, from global memory: LSTM
// w0 = wh (H, 4H); GRU w0 = whrz (H, 2H), w1 = whn (H, H), slot 3 none.
template <int KIND, typename TX>
__device__ __forceinline__ float wcol(const TX* w0, const TX* w1, int H,
                                      int k, int slot, int u) {
  if (KIND == 0) return load(w0, (long)k * 4 * H + slot * H + u);
  if (slot < 2) return load(w0, (long)k * 2 * H + slot * H + u);
  if (slot == 2) return load(w1, (long)k * H + u);
  return 0.0f;
}

// KIND 0: LSTM (gates i, f, g, o); KIND 1: GRU (r, z, n).
// xp (T, N, 4H | 3H); w0/w1 as wcol; bhn (H) for the GRU; h0/c0 (N, H);
// ys (T, N, H); hT/cT (N, H). TX: xp/w/bhn/ys type, TS: state type.
template <int KIND, typename TX, typename TS, int R>
__global__ void __launch_bounds__(1024)
rnn_cluster_kernel(const TX* __restrict__ xp, const TX* __restrict__ w0,
                   const TX* __restrict__ w1, const TX* __restrict__ bhn,
                   const TS* __restrict__ h0, const TS* __restrict__ c0,
                   TX* __restrict__ ys, TS* __restrict__ hT,
                   TS* __restrict__ cT, Geometry geo) {
  cg::cluster_group cluster = cg::this_cluster();
  const int T = geo.T, N = geo.N, H = geo.H, C = geo.C;
  const int Hq = (H + 3) / 4, Hp = 4 * Hq;
  const int G = KIND == 0 ? 4 * H : 3 * H;
  const int NG = KIND == 0 ? 4 : 3;  // weight columns a unit
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / C) * R;
  int u0, nu;
  unit_slice(rank, H, C, u0, nu);

  // [2] mbarriers (one per h buffer), h [2][R][Hp] f32, the weight slice
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  float* hbuf = reinterpret_cast<float*>(smem + 16);
  TX* wsm = reinterpret_cast<TX*>(smem + 16 + sizeof(float) * 2 * R * Hp);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&full[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // lane roles: a unit owns SPLIT consecutive lanes; lane s takes the
  // k-quads q = s, s + SPLIT, ... of all four slots
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = lane & (SPLIT - 1);
  const int ul = warp * (32 / SPLIT) + (lane / SPLIT);
  const bool live = ul < nu;
  const int u = live ? u0 + ul : 0;  // a valid index either way
  const int base = lane & ~(SPLIT - 1);
  const int slot = s / (SPLIT / 4);  // the slot it holds once reduced

  // h0 into buffer 0 (every unit, this cluster's rows), zeros elsewhere
  for (int i = threadIdx.x; i < 2 * R * Hp; i += blockDim.x) {
    const int b = i / (R * Hp), r = (i / Hp) % R, k = i % Hp;
    float v = 0.0f;
    if (b == 0 && k < H && n0 + r < N) v = load(h0, (long)(n0 + r) * H + k);
    hbuf[i] = v;
  }
  // the resident weight slice: zeros, then a lane takes one unit and
  // QUADS k-quads: it reads their rows of its unit's NG columns (a warp's
  // lanes read consecutive units of a row) and writes each column's quad
  // as one vector
  if (geo.resident) {
    const int kp = geo.col_stride, nwarps = blockDim.x >> 5;
    for (int i = threadIdx.x; i < Hq * kp * (int)sizeof(TX) / 2;
         i += blockDim.x)  // 8-byte stores: a quad is 8 or 16 bytes
      reinterpret_cast<uint2*>(wsm)[i] = make_uint2(0, 0);
    __syncthreads();
    constexpr int QUADS = 2;
    const int chunks = (nu + 31) / 32, groups = (Hq + QUADS - 1) / QUADS;
    for (int it = warp; it < groups * chunks; it += nwarps) {
      const int q0 = (it / chunks) * QUADS, uu = (it % chunks) * 32 + lane;
      if (uu >= nu) continue;
      float v[QUADS][4][4];
#pragma unroll
      for (int j = 0; j < QUADS; ++j)
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * (q0 + j) + kk;
            v[j][g][kk] = k < H ? wcol<KIND>(w0, w1, H, k, g, u0 + uu) : 0.0f;
          }
#pragma unroll
      for (int j = 0; j < QUADS; ++j)
        if (q0 + j < Hq) {
#pragma unroll
          for (int g = 0; g < NG; ++g)
            store4(wsm, (q0 + j) * kp + uu * 4 + g, v[j][g]);
        }
    }
  }

  // lanes s < R own row s of their unit: its c (LSTM)
  const int row = s;
  const bool owns_row = live && row < R && n0 + row < N;
  float c = (KIND == 0 && owns_row) ? load(c0, (long)(n0 + row) * H + u) : 0.0f;
  const float bn = (KIND == 1 && live) ? load(bhn, u) : 0.0f;
  // x_proj column of this lane's slot (GRU slot 2 has none, slot 3 is
  // x_proj's n part, column 2H + u)
  const bool has_x = live && (KIND == 0 || slot != 2);
  const int xcol = (KIND == 1 && slot == 3) ? 2 * H + u : slot * H + u;
  float xv[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    xv[r] = (has_x && n0 + r < N) ? load(xp, (long)(n0 + r) * G + xcol) : 0.0f;

  // every CTA of the cluster has started with its mbarriers set, and the
  // block sees its loads
  cluster.sync();
  const unsigned step_bytes = (unsigned)(R * H * sizeof(float));

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const float* hb = hbuf + cur * R * Hp;
    // step t's h has come (every unit, from every CTA); no warp of the
    // block lags a phase behind, then buffer 1 - cur is armed for the
    // bytes this step sends
    if (t > 0) wait_phase(smem_u32(&full[cur]), ((t - 1) >> 1) & 1);
    __syncthreads();
    if (threadIdx.x == 0 && t + 1 < T)
      expect_bytes(smem_u32(&full[1 - cur]), step_bytes);
    // next step's x_proj, in flight during this step's product
    float xn[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      xn[r] = (t + 1 < T && has_x && n0 + r < N)
                  ? load(xp, ((long)(t + 1) * N + n0 + r) * G + xcol)
                  : 0.0f;

    // acc[g][r]: slot g, row r, over this lane's k-quads
    float acc[4][R];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[g][r] = 0.0f;
    if (live) {
      for (int q = s; q < Hq; q += SPLIT) {
        float4 w[4];
        if (geo.resident) {
#pragma unroll
          for (int g = 0; g < NG; ++g)
            w[g] = load4(wsm, q * geo.col_stride + ul * 4 + g);
        } else {
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            float e[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              e[j] = 4 * q + j < H ? wcol<KIND>(w0, w1, H, 4 * q + j, g, u)
                                   : 0.0f;
            w[g] = make_float4(e[0], e[1], e[2], e[3]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 h = reinterpret_cast<const float4*>(hb + r * Hp)[q];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            acc[g][r] = fmaf(h.x, w[g].x, acc[g][r]);
            acc[g][r] = fmaf(h.y, w[g].y, acc[g][r]);
            acc[g][r] = fmaf(h.z, w[g].z, acc[g][r]);
            acc[g][r] = fmaf(h.w, w[g].w, acc[g][r]);
          }
        }
      }
    }
    // transposed reduction over the unit's SPLIT lanes, in a fixed order:
    // lanes with bit SPLIT/2 of s keep slots 2, 3 (else 0, 1) and add the
    // partner's (s ^ SPLIT/2); bit SPLIT/4 picks one of the two (partner
    // s ^ SPLIT/4); the remaining rounds add, so lanes g * SPLIT/4 and up
    // hold slot g
    const bool hi = s & (SPLIT / 2), lo = s & (SPLIT / 4);
    float d[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float keep = hi ? acc[j + 2][r] : acc[j][r];
        const float send = hi ? acc[j][r] : acc[j + 2][r];
        b[j] = keep + __shfl_xor_sync(FULL, send, SPLIT / 2);
      }
      const float keep = lo ? b[1] : b[0];
      const float send = lo ? b[0] : b[1];
      d[r] = keep + __shfl_xor_sync(FULL, send, SPLIT / 4);
#pragma unroll
      for (int off = SPLIT / 8; off > 0; off >>= 1)
        d[r] += __shfl_xor_sync(FULL, d[r], off);
    }
    // this slot's value: LSTM x_proj + h.W; GRU r, z as LSTM, slot 2
    // h.Whn + bhn, slot 3 x_proj's n part
    float val[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (KIND == 0 || slot < 2) val[r] = xv[r] + d[r];
      else if (slot == 2) val[r] = d[r] + bn;
      else val[r] = xv[r];
    }
    // row s's four slots into lane s, which updates it
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float v = __shfl_sync(FULL, val[r], base + g * (SPLIT / 4));
        if (row == r) p[g] = v;
      }
    float hn = 0.0f;
    if (row < R) {
      if (KIND == 0) {
        const float i = sigmoid(p[0]), f = sigmoid(p[1]), gg = tanhf(p[2]),
                    o = sigmoid(p[3]);
        c = f * c + i * gg;
        hn = o * tanhf(c);
      } else {
        const float rr = sigmoid(p[0]), z = sigmoid(p[1]);
        const float n = tanhf(p[3] + rr * p[2]);
        hn = (1.0f - z) * n + z * hb[row * Hp + u];
      }
    }
    if (t + 1 < T) {
      // the unit's R new values to every lane of the unit, which store
      // them into their peers' next buffers, each store completing on the
      // peer's mbarrier of that buffer
      float hr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) hr[r] = __shfl_sync(FULL, hn, base + r);
      if (live) {
        const unsigned nxt = smem_u32(hbuf + (1 - cur) * R * Hp + u);
        const unsigned bar = smem_u32(&full[1 - cur]);
        for (int pr = s; pr < C; pr += SPLIT) {
          const unsigned dst = peer_u32(nxt, pr), pbar = peer_u32(bar, pr);
#pragma unroll
          for (int r = 0; r < R; ++r)
            store_to_peer(dst + r * Hp * sizeof(float), hr[r], pbar);
        }
      }
    }
    if (owns_row) {
      store(ys, ((long)t * N + n0 + row) * H + u, hn);
      if (t + 1 == T) {
        store(hT, (long)(n0 + row) * H + u, hn);
        if (KIND == 0) store(cT, (long)(n0 + row) * H + u, c);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) xv[r] = xn[r];
  }
  // no CTA leaves while a peer's stores may still be on their way
  cluster.sync();
}

struct Plan {
  int C, R, resident, col_stride, threads, smem;
};

template <int KIND, typename TX, typename TS, int R>
cudaError_t prepare() {
  auto kernel = rnn_cluster_kernel<KIND, TX, TS, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t config(const Plan& p, int clusters, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C * clusters, 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KIND, typename TX, typename TS, int R>
int launch(const void* xp, const void* w0, const void* w1, const void* bhn,
           const void* h0, const void* c0, void* ys, void* hT, void* cT,
           int T, int N, int H, const Plan& p, cudaStream_t stream) {
  static const cudaError_t prepared = prepare<KIND, TX, TS, R>();
  if (prepared != cudaSuccess) return (int)prepared;
  cudaLaunchAttribute attr[1];
  const int clusters = (N + R - 1) / R;
  cudaLaunchConfig_t cfg = config(p, clusters, stream, attr);
  Geometry geo = {T, N, H, p.C, p.resident, p.col_stride};
  return (int)cudaLaunchKernelEx(
      &cfg, rnn_cluster_kernel<KIND, TX, TS, R>, (const TX*)xp,
      (const TX*)w0, (const TX*)w1, (const TX*)bhn, (const TS*)h0,
      (const TS*)c0, (TX*)ys, (TS*)hT, (TS*)cT, geo);
}

template <int KIND, typename TX, typename TS, int R>
int max_active(const Plan& p, int N, int* out) {
  static const cudaError_t prepared = prepare<KIND, TX, TS, R>();
  if (prepared != cudaSuccess) return (int)prepared;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      config(p, (N + R - 1) / R, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, rnn_cluster_kernel<KIND, TX, TS, R>, &cfg);
}

// One instantiation per (kind, x dtype, state dtype, rows a cluster).
#define MX_RNN_DISPATCH(KIND, CALL)                                      \
  do {                                                                   \
    typedef __nv_bfloat16 bf;                                            \
    const int key = (x_bf16 ? 8 : 0) + (s_bf16 ? 4 : 0) + (p.R - 1);    \
    switch (key) {                                                       \
      case 0: return CALL(KIND, float, float, 1);                        \
      case 1: return CALL(KIND, float, float, 2);                        \
      case 2: return CALL(KIND, float, float, 3);                        \
      case 3: return CALL(KIND, float, float, 4);                        \
      case 4: return CALL(KIND, float, bf, 1);                           \
      case 5: return CALL(KIND, float, bf, 2);                           \
      case 6: return CALL(KIND, float, bf, 3);                           \
      case 7: return CALL(KIND, float, bf, 4);                           \
      case 8: return CALL(KIND, bf, float, 1);                           \
      case 9: return CALL(KIND, bf, float, 2);                           \
      case 10: return CALL(KIND, bf, float, 3);                          \
      case 11: return CALL(KIND, bf, float, 4);                          \
      case 12: return CALL(KIND, bf, bf, 1);                             \
      case 13: return CALL(KIND, bf, bf, 2);                             \
      case 14: return CALL(KIND, bf, bf, 3);                             \
      case 15: return CALL(KIND, bf, bf, 4);                             \
    }                                                                    \
    return (int)cudaErrorInvalidValue;                                   \
  } while (0)

bool plan_ok(const Plan& p) {
  return p.R >= 1 && p.R <= 4 && p.C >= 1 && p.C <= 16 && p.threads >= 32 && p.threads <= 1024 &&
         p.threads % 32 == 0 && p.smem >= 0 && p.smem <= 232448;
}

}  // namespace

extern "C" {

// x_bf16: xp/wh/ys are bf16 (else f32); s_bf16: h0/c0/hT/cT are bf16.
// The plan (cluster size C, rows R, resident flag, column stride, threads,
// shared bytes) comes from scan_plan.
int mx_lstm_scan(const void* xp, const void* wh, const void* h0, const void* c0,
                 void* ys, void* hT, void* cT, int T, int N, int H, int x_bf16,
                 int s_bf16, int C, int R, int resident, int col_stride,
                 int threads, int smem, void* stream) {
  const Plan p = {C, R, resident, col_stride, threads, smem};
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define MX_CALL(K, TX, TS, RR) \
  launch<K, TX, TS, RR>(xp, wh, nullptr, nullptr, h0, c0, ys, hT, cT, T, N, H, p, st)
  MX_RNN_DISPATCH(0, MX_CALL);
#undef MX_CALL
}

// x_bf16: xp/whrz/whn/bhn/ys are bf16 (else f32); s_bf16: h0/hT are bf16.
int mx_gru_scan(const void* xp, const void* whrz, const void* whn,
                const void* bhn, const void* h0, void* ys, void* hT, int T,
                int N, int H, int x_bf16, int s_bf16, int C, int R,
                int resident, int col_stride, int threads, int smem,
                void* stream) {
  const Plan p = {C, R, resident, col_stride, threads, smem};
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define MX_CALL(K, TX, TS, RR)                                                \
  launch<K, TX, TS, RR>(xp, whrz, whn, bhn, h0, nullptr, ys, hT, nullptr, T, \
                        N, H, p, st)
  MX_RNN_DISPATCH(1, MX_CALL);
#undef MX_CALL
}

// cudaOccupancyMaxActiveClusters for a planned launch: kind 0 LSTM, 1 GRU.
int mx_rnn_max_active_clusters(int kind, int N, int x_bf16, int s_bf16, int C,
                               int R, int resident, int col_stride,
                               int threads, int smem, int* out) {
  const Plan p = {C, R, resident, col_stride, threads, smem};
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
#define MX_CALL(K, TX, TS, RR) max_active<K, TX, TS, RR>(p, N, out)
  if (kind == 0) MX_RNN_DISPATCH(0, MX_CALL);
  MX_RNN_DISPATCH(1, MX_CALL);
#undef MX_CALL
}

}  // extern "C"
