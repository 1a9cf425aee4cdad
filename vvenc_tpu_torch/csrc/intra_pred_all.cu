// K1 intra_pred_all: the 67 luma intra predictions of a batch of blocks.
//
// Replaces vvenc_tpu/ops/intra_presel.py:63 predict_all_modes (with
// _filter_refs_jnp :45 and _pdpc_planar_dc_jnp :217), an XLA program on
// the TPU.  Same arithmetic: [1 2 1] reference smoothing, the 65 angular
// modes as 4-tap sums over a gathered window of the (raw or filtered)
// reference pool, driven by the static tables of
// ops/intra_vec._shape_tables(w, h, True, 0) (uploaded once per (w, h) by
// ops/tables.device_tables), PDPC on the angular support slab, planar and
// DC with their PDPC.  The output is written directly in mode order
// [B, 67, h, w] int16, so no permutation pass follows.
//
// Bound: bytes.  Each block writes 67*h*w int16 samples from 2*(2s+3)
// int32 reference samples, about 13 integer operations per sample against
// 2 bytes written: at 3.35 TB/s and 67 T int-op/s the write bound is
// about 3x the operation bound.  Design: the grid is (candidate block,
// chunk of kChunk output samples); each thread block stages its
// candidate's reference pool (raw and filtered tops/lefts, 4*LPAD
// samples) in shared memory and walks its chunk of the [67, h, w] output
// linearly, so consecutive threads write consecutive int16 samples
// (coalesced stores), and the small per-mode tables are read through the
// read-only cache.  The chunks keep the card full when a batch holds few
// large blocks (a 64x64 candidate is 134 chunks).
// The per-sample arithmetic is intra_pred.cuh's, which K3's reference
// entry (plan_trial.cu) shares.
#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_pred.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8 * kThreads;  // output samples per thread block

__global__ void __launch_bounds__(kThreads) intra_pred_all_kernel(
    const int* __restrict__ tops, int tops_stride,
    const int* __restrict__ lefts, int lefts_stride,
    int16_t* __restrict__ out, int w, int h, int bit_depth,
    const intra_pred::Tables t) {
  // the candidate's pool [top | ftop | left | fleft] (intra_pred.cuh)
  extern __shared__ int pool[];
  __shared__ int s_dc;
  const int b = blockIdx.x;
  intra_pred::pool_load(tops + (size_t)b * tops_stride,
                        lefts + (size_t)b * lefts_stride, pool, t.LPAD,
                        threadIdx.x, blockDim.x);
  __syncthreads();
  intra_pred::pool_filter(pool, t.LPAD, w, h, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) s_dc = intra_pred::pool_dc(pool, t.LPAD, w, h);
  __syncthreads();

  const int hw = h * w;
  int16_t* ob = out + (size_t)b * 67 * hw;
  const int end = min(67 * hw, (int)(blockIdx.y + 1) * kChunk);
  for (int i = blockIdx.y * kChunk + threadIdx.x; i < end; i += blockDim.x) {
    const int mode = i / hw;
    const int r = i - mode * hw;
    const int yy = r / w, xx = r - (r / w) * w;
    ob[i] = (int16_t)intra_pred::pred_sample(pool, s_dc, t, w, h, bit_depth,
                                             mode, yy, xx);
  }
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// tops [B, tops_stride] / lefts [B, lefts_stride] int32 (stride >= LPAD),
// out [B, 67, h, w] int16; the tables are ops/tables.device_tables(w, h).
// Returns cudaGetLastError() after the launch on `stream`.
extern "C" int vt_intra_pred_all(
    const void* tops, int tops_stride, const void* lefts, int lefts_stride,
    void* out, int B, int w, int h, int bit_depth, const void* rm_flat,
    const void* row_start, const void* filt, const void* mode_info,
    const void* pdpc_wl, const void* side_flat, int LPAD, int LR, int TM,
    int B0, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const dim3 grid(B, (67 * w * h + kChunk - 1) / kChunk);
  const intra_pred::Tables t{(const int*)rm_flat, (const int*)row_start,
                             (const int*)filt, (const int*)mode_info,
                             (const int*)pdpc_wl, (const int*)side_flat,
                             LPAD, LR, TM, B0};
  intra_pred_all_kernel<<<grid, kThreads, 4 * LPAD * sizeof(int),
                          (cudaStream_t)stream>>>(
      (const int*)tops, tops_stride, (const int*)lefts, lefts_stride,
      (int16_t*)out, w, h, bit_depth, t);
  return (int)cudaGetLastError();
}
