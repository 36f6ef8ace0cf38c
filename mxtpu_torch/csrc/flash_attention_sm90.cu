// Flash attention for bf16 on Hopper tensor cores (sm_90a): the forward,
// dQ and dK/dV kernels, plain C interface.
//
// Replaces, for bfloat16 inputs, the three Pallas TPU kernels of
// mxtpu/ops/pallas_attention.py:
//   mx_flash_fwd_sm90      <- fwd_kernel      (pallas_attention.py:101, call :142)
//   mx_flash_bwd_dq_sm90   <- bwd_dq_kernel   (pallas_attention.py:173, call :236)
//   mx_flash_bwd_dkv_sm90  <- bwd_dkv_kernel  (pallas_attention.py:199, call :255)
// float32 inputs stay on the CUDA-core kernels of flash_attention.cu.  The
// kernels here compute exactly what flash_fwd_plain / flash_bwd_dq_plain /
// flash_bwd_dkv_plain compute (ops/flash_attention.py), under the same
// contract: layout (BH, T, D); offs = [q_off, k_off, kv_len, scale] read
// on the card; key j is live for query i iff j < kv_len and, when causal,
// q_off + i >= k_off + j; a row with no live key gives O = 0 and lse =
// -1e30 and adds nothing to dK or dV; O, dQ, dK and dV in bf16, lse f32;
// rows and keys past T are masked here, with no padding copies; keys past
// kv_len get dK = dV = 0.
//
// What bounds them on this card: the products.  Per live (query, key)
// pair the forward does 4*D flops (S = Q.K^T, O += P.V), dQ 6*D (S,
// dP = dO.V^T, dQ += dS.K) and dK/dV 8*D (S^T, dP^T, dV += P^T.dO,
// dK += dS^T.Q); at 8k tokens that is about 70 times the bytes the
// kernels must move at the bf16 tensor-core rate.  So every product runs
// on wgmma (bf16 x bf16 -> f32), and the tiles reach shared memory by TMA
// so that no thread spends instructions on the copy.
//
// The design, per block of one warpgroup (128 threads):
//   - forward and dQ own 64 Q rows: Q (and dO for dQ) is loaded once by
//     TMA; K and V tiles of 64 keys stream through a ring of two stages,
//     each guarded by an mbarrier.  dK/dV owns 64 keys the other way
//     round: K and V are loaded once, and tiles of 64 Q rows and their dO
//     rows stream through the ring, with the tile's lse and delta (each
//     thread loads one of the 128 values for the next tile while this one
//     is computed, and stores it to a two-deep shared copy before the
//     block's barrier).  Thread 0 refills a stage as soon as the
//     warpgroup has finished with it, so the next tile's copy is in flight
//     while this one is computed.
//   - The tensor maps are 3-D, (D, T, BH), so rows past T of one head read
//     as zeros and never as the next head's rows.  A row of a tile is
//     min(D, 64) bf16 in shared memory, swizzled to match the wgmma
//     descriptor: 128 B at D=64 (32 B and 64 B at D=16 and 32); at D=128 a
//     tile is two 64-column parts, each a TMA box of its own.
//   - S = Q.K^T (and dP = dO.V^T) read both operands from shared memory,
//     K-major.  P (and dS) is rounded to bf16 in registers, where the
//     accumulator's fragment is already the layout of wgmma's register A
//     operand, and O += P.V (dQ += dS.K) reads V (K) from shared memory
//     through the transpose bit (MN-major B).  dK/dV computes the
//     transposed scores directly, S^T = K.Q^T and dP^T = V.dO^T, so P^T
//     and dS^T land in the same register layout and dV += P^T.dO and
//     dK += dS^T.Q read dO and Q MN-major: no product needs a transpose
//     through shared memory.  Its lse and delta are per column (query):
//     each thread reads the 16 queries it holds from the shared copy.
//   - The online softmax runs on the accumulator fragment: each thread
//     holds two rows, and a row's max is reduced over the quad of lanes
//     that hold it; the row sum stays per lane until the end.  exp2f with
//     log2 e folded into the scale.  P is masked explicitly, not left to
//     exp: a fully-masked row has s = m = -1e30, and exp(s - m) would be 1
//     (in dQ and dK/dV, lse = -1e30 and exp(s - lse) would overflow to
//     inf, and inf * 0 is NaN).
//   - Whole tiles on the far side of the causal diagonal (or past kv_len)
//     are never loaded: each block reads its loop bounds from offs.  The
//     element mask runs only on tiles that straddle the diagonal, kv_len
//     or (dK/dV) the last Q row.
//   - Blocks are launched heaviest first, so the tail of the grid is
//     short: under a causal mask the last Q tiles see the most keys (fwd,
//     dQ) and the first key tiles the most queries (dK/dV).
// Not done here (later work): a producer warp with setmaxnreg, two
// warpgroups sharing a tile, softmax overlapped with the next tile's
// products, persistent blocks, fp8.
//
// Precision.  The TPU kernels widen their tiles to f32 and call
// dot_general at default precision, which on a TPU is one bf16 pass: the
// TPU rounds P and dS to bf16 before P.V, dS.K, P^T.dO and dS^T.Q.  These
// kernels do the same, so they depart from the f32 plain versions (not
// from what the TPU ran) by that rounding: at most 2^-8 of each p or ds.
// The allowance derived from it is in chip_smoke.py (SM90_*), and
// flash_fwd_bf16p_plain / flash_bwd_dq_bf16p_plain /
// flash_bwd_dkv_bf16p_plain are the plain model of this rounding.  S, dP,
// m, l, lse, delta and every accumulator are f32.
//
// Registers.  dK/dV at D=128 holds two 64 x 128 f32 accumulators (64 + 64
// registers a thread) beside the 64 x 64 S^T and dP^T (32 + 32) and the
// packed bf16 P^T and dS^T (16 + 16).  Issuing both SS products, then
// packing, then both RS products keeps no more than the accumulators and
// two 64 x 64 tiles live at once (192 registers): the build's ptxas
// report (chip_smoke.py prints it) gives 230 registers and no spills, so
// a Q tile of 64 rows needs no narrower step.
//
// The wrapper (mxtpu_torch/ops/flash_attention.py) checks devices, dtypes,
// shapes, contiguity and 16-byte alignment, allocates every output and
// passes PyTorch's current stream.  Each entry encodes its tensor maps,
// launches, and returns cudaGetLastError(), or kErrNoEncoder / kErrEncode
// + CUresult if a tensor map could not be made.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // _NEG of the Pallas kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kRows = 64;      // rows of every tile: Q rows, or keys
constexpr int kStages = 2;     // tiles in the ring: K/V, or Q/dO for dK/dV
constexpr int kThreads = 128;  // one warpgroup
constexpr int kErrNoEncoder = 10000;
constexpr int kErrEncode = 10001;

// A (64, D) bf16 tile in shared memory, as TMA writes it: kParts parts of
// 64 rows x kCols columns, each row kRowBytes (the swizzle width).
template <int D>
struct Tile {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kParts = D / kCols;
  static constexpr int kPartBytes = kRows * kRowBytes;
  static constexpr int kBytes = kRows * D * 2;
  // descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;  // 8 rows: one swizzle atom
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A copy that never lands (a bad tensor map, a wrong byte count) traps
// after about 2^24 polls, seconds, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// rows [row0, row0 + 64) of head bh into a tile, every part; completes on bar
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row0, int bh) {
  using L = Tile<D>;
#pragma unroll
  for (int p = 0; p < L::kParts; ++p)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst + p * L::kPartBytes),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(p * L::kCols), "r"(row0), "r"(bh), "r"(bar)
        : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor: start, leading and stride byte offsets
// (16 B units), swizzle layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// A tile read K-major (its D columns are the reduction): step kk covers
// columns 16kk .. 16kk + 15, 32 B into a swizzled row of its part
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = Tile<D>;
  const int col = 16 * kk;
  const uint32_t addr = tile + (col / L::kCols) * L::kPartBytes + (col % L::kCols) * 2;
  return make_desc(addr, 16, L::kGroupBytes, L::kLayout);
}

// A K/V tile read MN-major as the B of P.V or dS.K (its 64 rows are the
// reduction, its D columns the output): step kk covers rows 16kk ..
// 16kk + 15; the leading offset steps from one 64-column part to the next
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using L = Tile<D>;
  return make_desc(tile + kk * 16 * L::kRowBytes, L::kPartBytes, L::kGroupBytes, L::kLayout);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from touching accumulators across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64 f32) (+)= A (64 x 16, smem) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16 f32) += A (64 x 16, registers) * B (16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32 f32) += A (64 x 16, registers) * B (16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64 f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128 f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the fragment: thread t of the warpgroup holds, of a 64 x N accumulator,
// rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8; register i is row
// r0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + (i % 2).  Registers
// 8kk .. 8kk + 7 of an S fragment are, in order, the register A operand of
// the 16-key step kk.
// ---------------------------------------------------------------------------

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

// keys a Q tile must visit: up to the causal limit of its last row
__device__ __forceinline__ int key_end(const Offs& o, int q0, int causal) {
  if (!causal) return o.kv_len;
  return max(0, min(o.kv_len, o.q_off + q0 + kRows - o.k_off));
}

// every pair of the (Q tile, K tile) is live: no element mask needed
__device__ __forceinline__ bool tile_full(const Offs& o, int q0, int k0, int causal) {
  return k0 + kRows <= o.kv_len && (!causal || o.q_off + q0 >= o.k_off + k0 + kRows - 1);
}

__device__ __forceinline__ bool pair_live(const Offs& o, int qi, int kj, int causal) {
  return kj < o.kv_len && (!causal || o.q_off + qi >= o.k_off + kj);
}

// bit i set iff fragment register i (of a 64 x 64 S tile) is a live pair;
// row0 / col0 are this thread's first row and column in global terms
__device__ __forceinline__ uint32_t live_bits(const Offs& o, int row0, int col0, bool full,
                                              int causal) {
  if (full) return 0xffffffffu;
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i)
    bits |= (uint32_t)pair_live(o, row0 + 8 * ((i / 2) % 2), col0 + 8 * (i / 4) + (i % 2), causal)
            << i;
  return bits;
}

// as live_bits for a 64 x 64 S^T tile (rows are keys, columns queries),
// whose queries past Tq are dead too: key0 / q0c are this thread's first
// key and query; full: every pair of the tile is live
__device__ __forceinline__ uint32_t live_bits_t(const Offs& o, int key0, int q0c, int Tq,
                                                bool full, int causal) {
  if (full) return 0xffffffffu;
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) {
    const int qi = q0c + 8 * (i / 4) + (i % 2);
    bits |= (uint32_t)(qi < Tq && pair_live(o, qi, key0 + 8 * ((i / 2) % 2), causal)) << i;
  }
  return bits;
}

// the dynamic shared memory, aligned to the 1024 B a swizzle pattern spans
__device__ __forceinline__ uint32_t smem_base(const uint8_t* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// ---------------------------------------------------------------------------
// forward: O and lse for one (b*h, 64-row Q tile)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const float* __restrict__ offs,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int BH, int Tq, int Tk,
                int n_tiles, int causal) {
  using L = Tile<D>;
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = smem_base(smem_raw);
  const uint32_t skv = sq + L::kBytes;  // stage s: K at skv + 2s tiles, V after it
  const uint32_t qbar = smem_u32(&bars[0]);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - blockIdx.x / BH) * kRows;  // heaviest tiles first
  const Offs of = read_offs(offs, Tk);
  const int n_kt = (key_end(of, q0, causal) + kRows - 1) / kRows;

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(qbar, L::kBytes);
    tma_tile<D>(sq, &tq, qbar, q0, bh);
    for (int s = 0; s < kStages && s < n_kt; ++s) {
      const uint32_t bar = smem_u32(&bars[1 + s]);
      mbar_expect_tx(bar, 2 * L::kBytes);
      tma_tile<D>(skv + 2 * s * L::kBytes, &tk, bar, s * kRows, bh);
      tma_tile<D>(skv + (2 * s + 1) * L::kBytes, &tv, bar, s * kRows, bh);
    }
  }
  __syncthreads();

  const int r0 = 16 * warp + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // columns c0, c0 + 1 of each 8-column chunk
  const float sl2 = of.scale * kLog2e;  // scores in log2 units
  float acc[D / 2], sc[kRows / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) sc[i] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};  // l: this lane's columns only
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    const uint32_t sk = skv + 2 * s * L::kBytes, sv = sk + L::kBytes;
    mbar_wait(smem_u32(&bars[1 + s]), (t / kStages) & 1);

    // S = Q.K^T
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(sc, desc_k<D>(sq, kk), desc_k<D>(sk, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // online softmax on the fragment
    const int k0 = t * kRows;
    const uint32_t live = live_bits(of, q0 + r0, k0 + c0, tile_full(of, q0, k0, causal), causal);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      sc[i] = (live >> i) & 1u ? sc[i] * sl2 : kNeg;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
    uint32_t pa[kRows / 16][4];
#pragma unroll
    for (int i = 0; i < kRows / 2; i += 2) {
      const int h = (i / 2) % 2;
      const float p0 = (live >> i) & 1u ? exp2f(sc[i] - m[h]) : 0.0f;
      const float p1 = (live >> (i + 1)) & 1u ? exp2f(sc[i + 1] - m[h]) : 0.0f;
      l[h] += p0 + p1;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];

    // O += P.V
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mn<D>(sv, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);

    // the stage is free: refill it with tile t + kStages
    __syncthreads();
    if (tid == 0 && t + kStages < n_kt) {
      const uint32_t bar = smem_u32(&bars[1 + s]);
      mbar_expect_tx(bar, 2 * L::kBytes);
      tma_tile<D>(sk, &tk, bar, (t + kStages) * kRows, bh);
      tma_tile<D>(sv, &tv, bar, (t + kStages) * kRows, bh);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + r0 + 8 * h;
    if (row >= Tq) continue;
    const float l_safe = l[h] == 0.0f ? 1.0f : l[h];
    __nv_bfloat16* orow = o + ((long)bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + c0) =
          __floats2bfloat162_rn(acc[4 * c + 2 * h] / l_safe, acc[4 * c + 2 * h + 1] / l_safe);
    if (lane % 4 == 0)
      lse[(long)bh * Tq + row] = l[h] == 0.0f ? kNeg : m[h] * kLn2 + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ for one (b*h, 64-row Q tile):
//   dQ = sum_k ds K,  ds = p (dO.V^T - delta) scale,  p = exp(s scale - lse)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ offs, __nv_bfloat16* __restrict__ dq, int BH, int Tq,
               int Tk, int n_tiles, int causal) {
  using L = Tile<D>;
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = smem_base(smem_raw);
  const uint32_t sdo = sq + L::kBytes;
  const uint32_t skv = sdo + L::kBytes;
  const uint32_t qbar = smem_u32(&bars[0]);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - blockIdx.x / BH) * kRows;
  const Offs of = read_offs(offs, Tk);
  const int n_kt = (key_end(of, q0, causal) + kRows - 1) / kRows;

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(qbar, 2 * L::kBytes);
    tma_tile<D>(sq, &tq, qbar, q0, bh);
    tma_tile<D>(sdo, &tdo, qbar, q0, bh);
    for (int s = 0; s < kStages && s < n_kt; ++s) {
      const uint32_t bar = smem_u32(&bars[1 + s]);
      mbar_expect_tx(bar, 2 * L::kBytes);
      tma_tile<D>(skv + 2 * s * L::kBytes, &tk, bar, s * kRows, bh);
      tma_tile<D>(skv + (2 * s + 1) * L::kBytes, &tv, bar, s * kRows, bh);
    }
  }
  __syncthreads();

  const int r0 = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float sl2 = of.scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    lse2[h] = row < Tq ? lse[(long)bh * Tq + row] * kLog2e : 0.0f;
    dl[h] = row < Tq ? delta[(long)bh * Tq + row] : 0.0f;
  }
  float acc[D / 2], sc[kRows / 2], dp[kRows / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) sc[i] = dp[i] = 0.0f;
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    const uint32_t sk = skv + 2 * s * L::kBytes, sv = sk + L::kBytes;
    mbar_wait(smem_u32(&bars[1 + s]), (t / kStages) & 1);

    // S = Q.K^T and dP = dO.V^T
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(sc, desc_k<D>(sq, kk), desc_k<D>(sk, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<D>(sdo, kk), desc_k<D>(sv, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = t * kRows;
    const uint32_t live = live_bits(of, q0 + r0, k0 + c0, tile_full(of, q0, k0, causal), causal);
    uint32_t da[kRows / 16][4];
#pragma unroll
    for (int i = 0; i < kRows / 2; i += 2) {
      const int h = (i / 2) % 2;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = (live >> (i + e)) & 1u ? exp2f(sc[i + e] * sl2 - lse2[h]) : 0.0f;
        ds[e] = p * (dp[i + e] - dl[h]) * of.scale;
      }
      da[i / 8][(i % 8) / 2] = pack_bf16(ds[0], ds[1]);
    }

    // dQ += dS.K
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) wgmma_rs<D>(acc, da[kk], desc_mn<D>(sk, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);

    __syncthreads();
    if (tid == 0 && t + kStages < n_kt) {
      const uint32_t bar = smem_u32(&bars[1 + s]);
      mbar_expect_tx(bar, 2 * L::kBytes);
      tma_tile<D>(sk, &tk, bar, (t + kStages) * kRows, bh);
      tma_tile<D>(sv, &tv, bar, (t + kStages) * kRows, bh);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= Tq) continue;
    __nv_bfloat16* drow = dq + ((long)bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * c + c0) =
          __floats2bfloat162_rn(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// backward, dK and dV for one (b*h, 64-key tile), from the transposed
// scores:
//   S^T = K.Q^T,  p^T = exp(S^T scale - lse),  dP^T = V.dO^T,
//   ds^T = p^T (dP^T - delta) scale,  dV = sum_q p^T dO,  dK = sum_q ds^T Q
// The fragment's rows are keys and its columns queries, so lse and delta
// are per column.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ offs, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int BH, int Tq, int Tk, int causal) {
  using L = Tile<D>;
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  // lse * log2 e and delta of a Q tile's rows, two deep: [tile parity][which][row]
  __shared__ __align__(16) float rows[2][2][kRows];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = smem_base(smem_raw);
  const uint32_t sv = sk + L::kBytes;
  const uint32_t sqd = sv + L::kBytes;  // stage s: Q at sqd + 2s tiles, dO after it
  const uint32_t kvbar = smem_u32(&bars[0]);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x % BH;
  const int k0 = (blockIdx.x / BH) * kRows;  // heaviest (first) key tiles first
  const Offs of = read_offs(offs, Tk);
  // Q tiles from the first that can see key k0 to the last; none when
  // every key of the tile is past kv_len
  const int qstart = causal ? max(0, min(Tq, of.k_off + k0 - of.q_off)) : 0;
  const int t0 = qstart / kRows;
  const int n_qt = k0 < of.kv_len ? (Tq + kRows - 1) / kRows - t0 : 0;
  const float* lse_b = lse + (long)bh * Tq;
  const float* delta_b = delta + (long)bh * Tq;
  // this thread's one value of Q tile t's rows: lse * log2 e (tid < 64) or
  // delta, 0 past Tq
  auto row_value = [&](int t) {
    const int i = (t0 + t) * kRows + tid % kRows;
    if (i >= Tq) return 0.0f;
    return tid < kRows ? lse_b[i] * kLog2e : delta_b[i];
  };

  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (n_qt > 0) {
      mbar_expect_tx(kvbar, 2 * L::kBytes);
      tma_tile<D>(sk, &tk, kvbar, k0, bh);
      tma_tile<D>(sv, &tv, kvbar, k0, bh);
      for (int s = 0; s < kStages && s < n_qt; ++s) {
        const uint32_t bar = smem_u32(&bars[1 + s]);
        mbar_expect_tx(bar, 2 * L::kBytes);
        tma_tile<D>(sqd + 2 * s * L::kBytes, &tq, bar, (t0 + s) * kRows, bh);
        tma_tile<D>(sqd + (2 * s + 1) * L::kBytes, &tdo, bar, (t0 + s) * kRows, bh);
      }
    }
  }
  if (n_qt > 0) rows[0][tid / kRows][tid % kRows] = row_value(0);
  __syncthreads();

  const int r0 = 16 * warp + lane / 4;  // keys r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // queries c0, c0 + 1 of each 8-query chunk
  const float sl2 = of.scale * kLog2e;
  float dka[D / 2], dva[D / 2], st[kRows / 2], dpt[kRows / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) st[i] = dpt[i] = 0.0f;
  if (n_qt > 0) mbar_wait(kvbar, 0);

  for (int t = 0; t < n_qt; ++t) {
    const int s = t % kStages;
    const uint32_t sq = sqd + 2 * s * L::kBytes, sdo = sq + L::kBytes;
    const int q0 = (t0 + t) * kRows;
    // the next tile's lse / delta, loaded now and stored at the end
    const float next = t + 1 < n_qt ? row_value(t + 1) : 0.0f;
    mbar_wait(smem_u32(&bars[1 + s]), (t / kStages) & 1);

    // S^T = K.Q^T and dP^T = V.dO^T
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(st, desc_k<D>(sk, kk), desc_k<D>(sq, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, desc_k<D>(sv, kk), desc_k<D>(sdo, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    const bool full = q0 + kRows <= Tq && tile_full(of, q0, k0, causal);
    const uint32_t live = live_bits_t(of, k0 + r0, q0 + c0, Tq, full, causal);
    const float* lse2 = rows[t & 1][0];
    const float* dl = rows[t & 1][1];
    uint32_t pa[kRows / 16][4], da[kRows / 16][4];
#pragma unroll
    for (int i = 0; i < kRows / 2; i += 2) {
      const int col = 8 * (i / 4) + c0;  // the pair's first query in the tile
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
      const float p0 = (live >> i) & 1u ? exp2f(st[i] * sl2 - l2.x) : 0.0f;
      const float p1 = (live >> (i + 1)) & 1u ? exp2f(st[i + 1] * sl2 - l2.y) : 0.0f;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      da[i / 8][(i % 8) / 2] =
          pack_bf16(p0 * (dpt[i] - d2.x) * of.scale, p1 * (dpt[i + 1] - d2.y) * of.scale);
    }

    // dV += P^T.dO and dK += dS^T.Q, dO and Q read MN-major
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) wgmma_rs<D>(dva, pa[kk], desc_mn<D>(sdo, kk));
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) wgmma_rs<D>(dka, da[kk], desc_mn<D>(sq, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(dva);
    fence_regs(dka);

    // the other parity was last read in tile t - 1, before the previous
    // barrier; this barrier publishes it for tile t + 1
    rows[(t + 1) & 1][tid / kRows][tid % kRows] = next;
    // the stage is free: refill it with tile t + kStages
    __syncthreads();
    if (tid == 0 && t + kStages < n_qt) {
      const uint32_t bar = smem_u32(&bars[1 + s]);
      mbar_expect_tx(bar, 2 * L::kBytes);
      tma_tile<D>(sq, &tq, bar, (t0 + t + kStages) * kRows, bh);
      tma_tile<D>(sdo, &tdo, bar, (t0 + t + kStages) * kRows, bh);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + 8 * h;
    if (key >= Tk) continue;
    __nv_bfloat16* krow = dk + ((long)bh * Tk + key) * D;
    __nv_bfloat16* vrow = dv + ((long)bh * Tk + key) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * c + c0) =
          __floats2bfloat162_rn(dka[4 * c + 2 * h], dka[4 * c + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * c + c0) =
          __floats2bfloat162_rn(dva[4 * c + 2 * h], dva[4 * c + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded,
// so the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the 3-D map (D, T, BH) of a contiguous bf16 (BH, T, D) tensor, in boxes
// of 64 rows x min(D, 64) columns, swizzled as the descriptors expect;
// rows past T read as zeros
int encode(CUtensorMap* map, const void* ptr, int BH, int T, int D) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const int cols = D < 64 ? D : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

int tiles(int T) { return (T + kRows - 1) / kRows; }

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* offs, void* o,
               float* lse, int BH, int Tq, int Tk, int causal, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = encode(&mq, q, BH, Tq, D)) || (e = encode(&mk, k, BH, Tk, D)) ||
      (e = encode(&mv, v, BH, Tk, D)))
    return e;
  const int smem = Tile<D>::kBytes * (1 + 2 * kStages) + 1024;
  cudaError_t err = cudaFuncSetAttribute(fwd_sm90_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = tiles(Tq);
  fwd_sm90_kernel<D><<<BH * nt, kThreads, smem, s>>>(mq, mk, mv, offs, (__nv_bfloat16*)o, lse,
                                                      BH, Tq, Tk, nt, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const float* offs, void* dq, int BH, int Tq, int Tk, int causal,
              cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  int e;
  if ((e = encode(&mq, q, BH, Tq, D)) || (e = encode(&mk, k, BH, Tk, D)) ||
      (e = encode(&mv, v, BH, Tk, D)) || (e = encode(&mdo, dout, BH, Tq, D)))
    return e;
  const int smem = Tile<D>::kBytes * (2 + 2 * kStages) + 1024;
  cudaError_t err = cudaFuncSetAttribute(dq_sm90_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = tiles(Tq);
  dq_sm90_kernel<D><<<BH * nt, kThreads, smem, s>>>(mq, mk, mv, mdo, lse, delta, offs,
                                                     (__nv_bfloat16*)dq, BH, Tq, Tk, nt, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const float* offs, void* dk, void* dv, int BH, int Tq, int Tk,
               int causal, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  int e;
  if ((e = encode(&mq, q, BH, Tq, D)) || (e = encode(&mk, k, BH, Tk, D)) ||
      (e = encode(&mv, v, BH, Tk, D)) || (e = encode(&mdo, dout, BH, Tq, D)))
    return e;
  const int smem = Tile<D>::kBytes * (2 + 2 * kStages) + 1024;
  cudaError_t err = cudaFuncSetAttribute(dkv_sm90_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dkv_sm90_kernel<D><<<BH * tiles(Tk), kThreads, smem, s>>>(
      mq, mk, mv, mdo, lse, delta, offs, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, BH, Tq, Tk,
      causal);
  return (int)cudaGetLastError();
}

#define MX_SM90_DISPATCH(D, CALL)     \
  do {                                \
    switch (D) {                      \
      case 16: return CALL(16);       \
      case 32: return CALL(32);       \
      case 64: return CALL(64);       \
      case 128: return CALL(128);     \
    }                                 \
    return (int)cudaErrorInvalidValue; \
  } while (0)

}  // namespace

extern "C" {

// q (BH, Tq, D), k/v (BH, Tk, D), all bf16, contiguous, 16-byte aligned;
// offs 4 f32 on the card; writes o (BH, Tq, D) bf16 and lse (BH, Tq) f32.
int mx_flash_fwd_sm90(const void* q, const void* k, const void* v, const void* offs, void* o,
                      void* lse, int BH, int Tq, int Tk, int D, int causal, void* stream) {
#define MX_FWD(DD) \
  launch_fwd<DD>(q, k, v, (const float*)offs, o, (float*)lse, BH, Tq, Tk, causal, (cudaStream_t)stream)
  MX_SM90_DISPATCH(D, MX_FWD);
#undef MX_FWD
}

// as mx_flash_fwd_sm90 plus dout (BH, Tq, D) bf16 and lse/delta (BH, Tq)
// f32; writes dq (BH, Tq, D) bf16.
int mx_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* offs, void* dq, int BH,
                         int Tq, int Tk, int D, int causal, void* stream) {
#define MX_DQ(DD)                                                                              \
  launch_dq<DD>(q, k, v, dout, (const float*)lse, (const float*)delta, (const float*)offs, dq, \
                BH, Tq, Tk, causal, (cudaStream_t)stream)
  MX_SM90_DISPATCH(D, MX_DQ);
#undef MX_DQ
}

// as mx_flash_bwd_dq_sm90; writes dk and dv (BH, Tk, D) bf16.
int mx_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const void* offs, void* dk,
                          void* dv, int BH, int Tq, int Tk, int D, int causal, void* stream) {
#define MX_DKV(DD)                                                                              \
  launch_dkv<DD>(q, k, v, dout, (const float*)lse, (const float*)delta, (const float*)offs, dk, \
                 dv, BH, Tq, Tk, causal, (cudaStream_t)stream)
  MX_SM90_DISPATCH(D, MX_DKV);
#undef MX_DKV
}

}  // extern "C"
