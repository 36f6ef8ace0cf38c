// Greedy non-maximum suppression for MultiBoxDetection (and Proposal), in
// float32 on the CUDA cores (sm_90a), plain C interface.
//
// Not a TPU kernel: mxtpu runs this pass as a lax.fori_loop over every
// score-sorted row (mxtpu/ops/vision.py:305-315, inside MultiBoxDetection's
// vmap; the same loop in Proposal, :395-399).  Its plain version is
// multibox_nms_plain in mxtpu_torch/ops/vision.py, that loop in torch.
//
// The pass is one dependence chain: whether row i suppresses anything
// depends on whether an earlier row suppressed i.  So one block walks one
// image's rows in order, CHUNK (32) rows at a time:
//   1. the block's first warp settles the chunk among itself: lane l holds
//      row i0 + l; for k = 0 .. 31 in order, if row i0 + k is live (alive,
//      a class, below limit) the lanes after it test their rows against
//      it, and the live rows form the chunk's survivor mask;
//   2. after a barrier, every thread takes rows j past the chunk (and
//      below limit) and clears alive[j] where a survivor of j's class (any
//      class under force_suppress) overlaps it by more than the threshold;
//   3. a barrier ends the chunk.
// A row dies exactly when an earlier row that survived its own turn
// overlaps it, so this gives the serial loop's result: the order in
// which the survivors test a later row does not matter.  No A x A IoU
// matrix exists anywhere (mxtpu's vmap builds one: 305 MB an image at
// SSD-300's 8,732 anchors).
//
// What bounds it: the chain, not bytes or operations (an image reads 20
// bytes a row and does ~21 operations per pair it tests).  The design
// keeps the chain short: two barriers a chunk of 32 rows, not one a row;
// the alive flags, the classes and, where they fit (8,732 rows:
// 183 KB), the boxes sit in shared memory, loaded once.  Images are
// independent, one block each, on as many SMs.
//
// The IoU is computed as torch computes _corner_iou (vision.py), with
// every product, sum and quotient rounded on its own (no fused
// multiply-add), so the kernel and its plain version agree bit for bit.
// Lanes of a warp test different pairs, and a warp runs the IoU's
// quotient when any of its lanes needs it; so the quotient is skipped
// where the boxes do not overlap (the IoU is 0 there).  Measured on an
// H100 at 8,732 rows of 21 classes, that divergence, not the barriers,
// took most of the 11-13 ms of the kernel without the skip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// Whether the IoU of corner boxes a and b, inter / (area_a + area_b - inter)
// (0 where that union is not positive), exceeds thr.  Most pairs do not
// overlap; for them the IoU is 0 and the areas and the quotient are not
// computed, which keeps a warp whose lanes test different pairs short.
__device__ __forceinline__ bool iou_above(float4 a, float4 b, float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  if (!(inter > 0.f)) return 0.f > thr;
  const float uni = __fsub_rn(__fadd_rn(box_area(a), box_area(b)), inter);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > thr;
}

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) & ~size_t(15); }

constexpr int CHUNK = 32;
constexpr unsigned FULL = 0xffffffffu;

// boxes (B, A, 4) and cls (B, A) sorted by score; out (B, A): cls where the
// row survives and lies below limit, else -1.  Shared memory: the chunk's
// survivor mask (16 bytes), alive[A] bytes, cls[A] floats, and the boxes
// when boxes_in_smem.
__global__ void multibox_nms_kernel(const float4* __restrict__ boxes,
                                    const float* __restrict__ cls, float* __restrict__ out,
                                    int A, int limit, float thr, int force,
                                    int boxes_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* survivors = reinterpret_cast<unsigned*>(smem);
  unsigned char* alive = smem + 16;
  float* scls = reinterpret_cast<float*>(alive + up16(A));
  float4* sbox = reinterpret_cast<float4*>(alive + up16(A) + up16(size_t(A) * 4));
  const size_t base = size_t(blockIdx.x) * A;
  const float4* gbox = boxes + base;
  for (int j = threadIdx.x; j < A; j += blockDim.x) {
    alive[j] = 1;
    scls[j] = cls[base + j];
    if (boxes_in_smem) sbox[j] = gbox[j];
  }
  __syncthreads();
  const float4* bx = boxes_in_smem ? sbox : gbox;
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < limit; i0 += CHUNK) {
    if (threadIdx.x < 32) {  // 1. the chunk among itself, in order
      const int i = i0 + lane;
      const bool in = i < limit;
      const float4 b = in ? bx[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float c = in ? scls[i] : -1.f;
      int live = in && alive[i] && c >= 0.f;
      unsigned mask = 0;
      for (int k = 0; k < CHUNK; ++k) {
        if (!__shfl_sync(FULL, live, k)) continue;  // the same for every lane
        mask |= 1u << k;
        const float4 bk = make_float4(__shfl_sync(FULL, b.x, k), __shfl_sync(FULL, b.y, k),
                                      __shfl_sync(FULL, b.z, k), __shfl_sync(FULL, b.w, k));
        const float ck = __shfl_sync(FULL, c, k);
        if (lane > k && live && (force || c == ck) && iou_above(bk, b, thr)) live = 0;
      }
      if (in) alive[i] = live;
      if (lane == 0) *survivors = mask;
    }
    __syncthreads();
    const unsigned mask = *survivors;
    if (mask) {  // 2. the rows past the chunk against its survivors
      for (int j = i0 + CHUNK + threadIdx.x; j < limit; j += blockDim.x) {
        if (!alive[j]) continue;  // a dead row stays dead
        const float cj = scls[j];
        if (!force && !(cj >= 0.f)) continue;  // no survivor shares no class
        const float4 bj = bx[j];
        for (unsigned m = mask; m; m &= m - 1) {
          const int i = i0 + __ffs(m) - 1;
          if (!force && scls[i] != cj) continue;
          if (iou_above(bx[i], bj, thr)) {
            alive[j] = 0;
            break;
          }
        }
      }
    }
    __syncthreads();  // 3.
  }
  for (int j = threadIdx.x; j < A; j += blockDim.x)
    out[base + j] = (alive[j] && j < limit) ? scls[j] : -1.f;
}

}  // namespace

extern "C" {

// boxes (B, A, 4) f32, cls (B, A) f32, out (B, A) f32, all on the card and
// contiguous; one block of `threads` an image on `stream`.  Returns
// cudaGetLastError() after the launch.
int mx_multibox_nms(const void* boxes, const void* cls, void* out, int B, int A, int limit,
                    float thr, int force, int threads, void* stream) {
  const size_t flags = 16 + up16(size_t(A)) + up16(size_t(A) * 4);
  const size_t with_boxes = flags + size_t(A) * 16;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int in_smem = with_boxes <= size_t(optin);
  const size_t smem = in_smem ? with_boxes : flags;
  if (smem > size_t(optin)) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(multibox_nms_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  multibox_nms_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), reinterpret_cast<const float*>(cls),
      reinterpret_cast<float*>(out), A, limit, thr, force, in_smem);
  return int(cudaGetLastError());
}

}  // extern "C"
