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
// Bound: bytes.  Each block writes 67*h*w int16 samples from 2*LPAD int32
// reference samples; at 3.35 TB/s the 1080p 16x16 class (8,040 blocks,
// 278 MB) takes 0.083 ms, about 4x its operation bound.  Every sample
// costs a 4-tap sum, a round and a clip (PDPC adds a few), so the kernel
// has about 11 issue slots a sample to stay at the byte bound; it runs
// at about half of that rate (chip_smoke.py phase 3 times it).
//
// Design (the first kernel walked [67, h, w] in 2,048-sample chunks, one
// thread a sample: two runtime divisions, a branch on the mode that
// diverged inside a warp, about 15 table words a sample through the
// read-only cache, 2-byte stores, and the pool staged again for every
// chunk):
// - one instantiation per (w, h): divisions are shifts, loops unroll;
// - a work item is one block and a range of its modes: all 67 (two items
//   on the 64-point classes, whose mains would not fit), or fewer when a
//   batch holds too few blocks to fill the card (search_step's 4 blocks
//   of 16x16 are 36 items of 8 modes, as the first kernel's 36 chunks);
//   its thread block stages and filters the block's pool once, as int32
//   (planar, DC) and as the float of its int16 cast (angular modes),
//   computes DC with one warp, and gathers each mode's reference main
//   (the mode's row of rm_flat, LR pool positions) into shared memory;
// - a task is a run of R = min(16, w, h) samples along one main row of
//   one mode: from 16x16 a warp spans at most two modes, so the mode's
//   branch rarely diverges; the row's start and its 4 taps are read once
//   a task (one task ahead), its window is R + 3 contiguous shared reads,
//   its R sums are independent (the ILP that hides the shared latency;
//   runs of 8 were slower on an H100 from 16x16 on);
// - the sums run on the float32 pipe, where they are exact: values are
//   int16, taps within [-6, 64], so every partial sum is an integer below
//   2^22; (acc + rnd) >> shift is rint((acc + rnd - 2^(shift-1) + 0.5) /
//   2^shift), one fused multiply-add onto 1.5 * 2^23 (the argument is
//   never a half-integer), whose float bits then hold the clipped sample
//   in their low 16 bits; PDPC's ((wl * d + 32) >> 6) likewise, its
//   weights and side positions read 4 columns a load;
// - vertical modes (and planar, DC) store a task's run as 16-byte
//   vectors (8 bytes at w or h = 4); horizontal modes, whose main rows
//   are output columns, give consecutive lanes consecutive main rows, so
//   each of the run's 2-byte stores is coalesced across the warp;
// - no copy pipeline: 8 to 16 resident blocks an SM hide the pool's and
//   the tables' latency (a persistent grid with the next block's
//   references in flight was slower on an H100).
// tests/test_torch_k12_models.py holds the float32-pipe rounding, the
// gathered mains and the store layout against the reference.  Planar and
// DC are intra_pred.cuh's integer arithmetic, which K3's reference entry
// (plan_trial.cu) shares.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "intra_pred.cuh"

namespace {

using intra_pred::kFlagAng0;
using intra_pred::kFlagPdpc;
using intra_pred::kFlagVer;

constexpr int kModes = 67;
constexpr int kPdpcCols = 12;             // ops/tables.PDPC_COLS
constexpr int kListBytes = 40 * 1024;     // gathered mains of one item
constexpr int kGather = 8;                // gather indices in flight
constexpr float kMagic = 12582912.0f;     // 1.5 * 2^23

__host__ __device__ constexpr int ilog2c(int v) {
  return v <= 1 ? 0 : 1 + ilog2c(v >> 1);
}

template <int W, int H>
struct Geo {
  static constexpr int TM = W > H ? W : H;
  static constexpr int LPAD = 2 * TM + 3;
  // the run: R samples along a main row (R divides w and h)
  static constexpr int R = (W < H ? W : H) < 16 ? (W < H ? W : H) : 16;
  static constexpr int TPM = W * H / R;              // tasks per mode
  // threads: about 8 passes over a block's 67 * TPM tasks, 128 to 256
  static constexpr int NT_RAW = 1 << ilog2c(kModes * TPM / 8);
  static constexpr int NT = NT_RAW < 128 ? 128 : (NT_RAW > 256 ? 256 : NT_RAW);
  // resident blocks asked of the compiler: a cap of 64 registers, under
  // which no instantiation spills (without it ptxas spills 4 bytes at
  // 48 registers on the R = 8, 128-thread classes)
  static constexpr int MIN_BLOCKS = 65536 / (NT * 64);
};

// an integer |x| < 2^22 as a float (two full-rate operations)
__device__ __forceinline__ float i2f(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), kMagic);
}

// one task: a run of R samples along main row r of `mode` from main column
// c0, with the row's tables
struct Task {
  int mode, r, c0, flags, rs;
  float f0, f1, f2, f3, acc0, scale;
};

template <int W, int H>
__device__ __forceinline__ Task task_of(int t, const intra_pred::Tables& tb) {
  using G = Geo<W, H>;
  Task q;
  q.mode = t >> ilog2c(G::TPM);
  const int k = t & (G::TPM - 1);
  if (q.mode < 2) {
    q.flags = kFlagVer;  // planar and DC: output rows
  } else {
    const int mi = q.mode - 2;
    const int4 info = __ldg(reinterpret_cast<const int4*>(tb.mode_info) + mi);
    q.flags = info.z;
    q.acc0 = __fadd_rn(i2f(info.y - (1 << (info.x - 1))), 0.5f);
    q.scale = __int_as_float((127 - info.x) << 23);  // 2^-shift
  }
  if (q.flags & kFlagVer) {
    // main rows are output rows (h of them, W / R runs each)
    q.r = k >> ilog2c(W / G::R);
    q.c0 = (k & (W / G::R - 1)) * G::R;
  } else {
    // main rows are output columns: consecutive tasks, consecutive rows
    q.r = k & (W - 1);
    q.c0 = (k >> ilog2c(W)) * G::R;
  }
  if (q.mode >= 2) {
    const int mi = q.mode - 2;
    q.rs = __ldg(tb.row_start + mi * G::TM + q.r);
    const int4 f = __ldg(reinterpret_cast<const int4*>(tb.filt) +
                         mi * G::TM + q.r);
    q.f0 = i2f(f.x);
    q.f1 = i2f(f.y);
    q.f2 = i2f(f.z);
    q.f3 = i2f(f.w);
  }
  return q;
}

__device__ __forceinline__ float clampf(float v, float hi) {
  return fminf(fmaxf(v, kMagic), hi);
}

// one task: its R samples computed and stored
template <int W, int H>
__device__ __forceinline__ void task_run(
    const Task& q, int b, int m_lo, const int* pool, const float* poolf,
    const float* lists, int dc, int bit_depth, float vmax,
    const intra_pred::Tables& tb, int16_t* __restrict__ out) {
  using G = Geo<W, H>;
  constexpr int R = G::R, LPAD = G::LPAD;
  const int LR = tb.LR;
  uint32_t bits[R];
  if (q.mode < 2) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      bits[j] = (uint32_t)intra_pred::planar_dc_sample(
          pool, dc, LPAD, W, H, bit_depth, q.mode, q.r, q.c0 + j);
  } else {
    const int mi = q.mode - 2;
    const float* win = lists + (q.mode - m_lo) * LR + q.rs + q.c0;
    float x[R + 3], v[R];
#pragma unroll
    for (int i = 0; i < R + 3; ++i) x[i] = win[i];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float a = __fmaf_rn(q.f0, x[j], q.acc0);
      a = __fmaf_rn(q.f1, x[j + 1], a);
      a = __fmaf_rn(q.f2, x[j + 2], a);
      a = __fmaf_rn(q.f3, x[j + 3], a);
      v[j] = clampf(__fmaf_rn(a, q.scale, kMagic), vmax);
    }
    if ((q.flags & kFlagPdpc) && q.c0 < kPdpcCols) {
      // the run's PDPC weights and side positions, 4 columns a load
      const bool ang0 = q.flags & kFlagAng0;
      const float tl =
          ang0 ? poolf[__ldg(tb.rm_flat + mi * LR + tb.B0)] : 0.0f;
      const int4* wl4 = reinterpret_cast<const int4*>(
          tb.pdpc_wl + mi * G::TM + q.c0);
      const int4* sx4 = reinterpret_cast<const int4*>(
          tb.side_flat + (mi * G::TM + q.r) * G::TM + q.c0);
#pragma unroll
      for (int g = 0; g < R / 4; ++g) {
        if (q.c0 + 4 * g >= kPdpcCols) break;
        const int4 wl = __ldg(wl4 + g), sx = __ldg(sx4 + g);
        const int wls[4] = {wl.x, wl.y, wl.z, wl.w};
        const int sxs[4] = {sx.x, sx.y, sx.z, sx.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (wls[j] == 0) continue;
          float& vj = v[4 * g + j];
          const float base = ang0 ? tl : __fsub_rn(vj, kMagic);
          // ((wl * (lval - base) + 32) >> 6), exact as above
          const float e = __fmaf_rn(__fsub_rn(poolf[sxs[j]], base),
                                    i2f(wls[j]), 0.5f);
          const float d =
              __fsub_rn(__fmaf_rn(e, 0.015625f, kMagic), kMagic);
          vj = clampf(__fadd_rn(vj, d), vmax);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) bits[j] = __float_as_uint(v[j]);
  }
  int16_t* ob = out + ((size_t)b * kModes + q.mode) * (W * H);
  if (q.flags & kFlagVer) {
    uint32_t wd[R / 2];
#pragma unroll
    for (int j = 0; j < R / 2; ++j)
      wd[j] = __byte_perm(bits[2 * j], bits[2 * j + 1], 0x5410);
    if constexpr (R == 4) {
      *reinterpret_cast<uint2*>(ob + q.r * W + q.c0) =
          make_uint2(wd[0], wd[1]);
    } else {
#pragma unroll
      for (int g = 0; g < R / 8; ++g)
        reinterpret_cast<uint4*>(ob + q.r * W + q.c0)[g] = make_uint4(
            wd[4 * g], wd[4 * g + 1], wd[4 * g + 2], wd[4 * g + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      ob[(q.c0 + j) * W + q.r] = (int16_t)bits[j];
  }
}

template <int W, int H>
__global__ void __launch_bounds__(Geo<W, H>::NT, Geo<W, H>::MIN_BLOCKS)
intra_pred_all_kernel(
    const int* __restrict__ tops, int tops_stride,
    const int* __restrict__ lefts, int lefts_stride,
    int16_t* __restrict__ out, int bit_depth, const intra_pred::Tables tb,
    int mpi, int nsplit) {
  using G = Geo<W, H>;
  constexpr int NT = G::NT, LPAD = G::LPAD;
  extern __shared__ int smem[];
  int* pool = smem;                                        // [4 * LPAD]
  float* poolf = reinterpret_cast<float*>(smem + 4 * LPAD);
  float* lists = poolf + 4 * LPAD;                         // [mpi, LR]
  __shared__ int s_dc;
  const int LR = tb.LR, tid = threadIdx.x;
  const int b = blockIdx.x / nsplit;
  const int m_lo = (blockIdx.x - b * nsplit) * mpi;
  const int m_hi = min(kModes, m_lo + mpi);
  const int t_end = m_hi * G::TPM;

  // what does not wait for the pool: the first task's tables and the
  // first gather indices (the angular modes' mains are contiguous rows of
  // rm_flat, and land contiguously in `lists`)
  int t = m_lo * G::TPM + tid;
  Task nxt{};
  if (t < t_end) nxt = task_of<W, H>(t, tb);
  const int a_lo = max(m_lo, 2);
  const int n_list = m_hi > a_lo ? (m_hi - a_lo) * LR : 0;
  const int* gsrc = tb.rm_flat + (a_lo - 2) * LR;
  float* gdst = lists + (a_lo - m_lo) * LR;
  int gi[kGather];
#pragma unroll
  for (int u = 0; u < kGather; ++u) {
    const int k = tid + u * NT;
    gi[u] = k < n_list ? __ldg(gsrc + k) : 0;
  }

  intra_pred::pool_load(tops + (size_t)b * tops_stride,
                        lefts + (size_t)b * lefts_stride, pool, LPAD, tid, NT);
  __syncthreads();
  intra_pred::pool_filter(pool, LPAD, W, H, tid, NT);
  __syncthreads();
  for (int j = tid; j < 4 * LPAD; j += NT) poolf[j] = (float)(int16_t)pool[j];
  if (tid < 32) {
    // DC (intra_pred::pool_dc) by the first warp: the average of both
    // sides (square) or of the longer side only
    constexpr int denom = W == H ? 2 * W : G::TM;
    int s = 0;
    if (W >= H)
      for (int x = 1 + tid; x <= W; x += 32) s += pool[x];
    if (W <= H)
      for (int y = 1 + tid; y <= H; y += 32) s += pool[2 * LPAD + y];
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
    if (tid == 0) s_dc = (s + (denom >> 1)) >> ilog2c(denom);
  }
  __syncthreads();
  for (int k0 = tid; k0 < n_list; k0 += kGather * NT) {
#pragma unroll
    for (int u = 0; u < kGather; ++u)
      if (k0 + u * NT < n_list) gdst[k0 + u * NT] = poolf[gi[u]];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int k = k0 + (kGather + u) * NT;
      gi[u] = k < n_list ? __ldg(gsrc + k) : 0;
    }
  }
  __syncthreads();

  const float vmax = kMagic + (float)((1 << bit_depth) - 1);
  for (; t < t_end; t += NT) {
    const Task q = nxt;
    if (t + NT < t_end) nxt = task_of<W, H>(t + NT, tb);
    task_run<W, H>(q, b, m_lo, pool, poolf, lists, s_dc, bit_depth, vmax,
                   tb, out);
  }
}

// one instantiation: its kernel, threads, tasks per mode and 4 * LPAD
struct Inst {
  const void* f;
  int nt, tpm, lpad;
};

template <int W, int H>
Inst inst() {
  using G = Geo<W, H>;
  return {(const void*)intra_pred_all_kernel<W, H>, G::NT, G::TPM, G::LPAD};
}

template <int W>
Inst inst_h(int h) {
  switch (h) {
    case 4: return inst<W, 4>();
    case 8: return inst<W, 8>();
    case 16: return inst<W, 16>();
    case 32: return inst<W, 32>();
    default: return inst<W, 64>();
  }
}

Inst inst_wh(int w, int h) {
  switch (w) {
    case 4: return inst_h<4>(h);
    case 8: return inst_h<8>(h);
    case 16: return inst_h<16>(h);
    case 32: return inst_h<32>(h);
    default: return inst_h<64>(h);
  }
}

bool valid_side(int n) { return n >= 4 && n <= 64 && (n & (n - 1)) == 0; }

int g_sms[16];  // per device: SM count (0: not queried yet)

// the split of each block's modes over work items for a batch of B blocks:
// all 67 modes in one item (two on the 64-point classes, whose mains do
// not fit kListBytes), or, when the batch cannot fill the card, as many
// items a block as keep one full pass of tasks each
void split(const Inst& k, int LR, long long B, int sms, int& mpi,
           int& nsplit) {
  const int cap = kListBytes / (LR * 4);
  const int lo = (kModes + cap - 1) / cap;
  const int per_pass = (k.nt + k.tpm - 1) / k.tpm;  // modes a pass holds
  const int hi = std::max(lo, (kModes + per_pass - 1) / per_pass);
  const long long want = (4LL * sms + B - 1) / B;
  nsplit = (int)std::min((long long)hi, std::max((long long)lo, want));
  mpi = (kModes + nsplit - 1) / nsplit;
  nsplit = (kModes + mpi - 1) / mpi;
}

size_t smem_bytes(const Inst& k, int LR, int mpi) {
  return (size_t)(8 * k.lpad + mpi * LR) * 4;
}

cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& s = g_sms[dev & 15];
  if (s == 0) {
    e = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  sms = s;
  return cudaSuccess;
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// tops [B, tops_stride] / lefts [B, lefts_stride] int32 (stride >= LPAD),
// out [B, 67, h, w] int16; the tables are ops/tables.device_tables(w, h)
// (each 16-byte aligned).  Returns cudaGetLastError() after the launch on
// `stream`.
extern "C" int vt_intra_pred_all(
    const void* tops, int tops_stride, const void* lefts, int lefts_stride,
    void* out, int B, int w, int h, int bit_depth, const void* rm_flat,
    const void* row_start, const void* filt, const void* mode_info,
    const void* pdpc_wl, const void* side_flat, int LPAD, int LR, int TM,
    int B0, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (!valid_side(w) || !valid_side(h) || B < 0 || bit_depth < 1 ||
      bit_depth > 16 || TM != std::max(w, h) || LPAD != 2 * TM + 3 ||
      LR < 1 || tops_stride < LPAD || lefts_stride < LPAD)
    return (int)cudaErrorInvalidValue;
  // int4 loads of mode_info, filt, pdpc_wl and side_flat rows
  if (((uintptr_t)filt | (uintptr_t)mode_info | (uintptr_t)pdpc_wl |
       (uintptr_t)side_flat) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (B == 0) return 0;
  const Inst k = inst_wh(w, h);
  int sms = 0;
  cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return (int)e;
  int mpi, nsplit;
  split(k, LR, B, sms, mpi, nsplit);
  const long long grid = (long long)B * nsplit;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const intra_pred::Tables t{(const int*)rm_flat, (const int*)row_start,
                             (const int*)filt, (const int*)mode_info,
                             (const int*)pdpc_wl, (const int*)side_flat,
                             LPAD, LR, TM, B0};
  void* args[] = {(void*)&tops, (void*)&tops_stride, (void*)&lefts,
                  (void*)&lefts_stride, (void*)&out, (void*)&bit_depth,
                  (void*)&t, (void*)&mpi, (void*)&nsplit};
  e = cudaLaunchKernel(k.f, dim3((unsigned)grid), dim3(k.nt), args,
                       smem_bytes(k, LR, mpi), (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the resources of the kernel of a (w, h) class as a large batch launches
// it (one item a block; LR = 3 max(w, h) + 12, ops/intra_vec's main
// length): out = registers per thread, static and dynamic shared memory
// bytes, threads per block, resident blocks per SM, local memory bytes
// per thread.
extern "C" int vt_intra_pred_all_attrs(int w, int h, int* out) {
  if (!valid_side(w) || !valid_side(h)) return (int)cudaErrorInvalidValue;
  const Inst k = inst_wh(w, h);
  const int LR = 3 * std::max(w, h) + 12;
  int mpi, nsplit;
  split(k, LR, 1LL << 30, 1, mpi, nsplit);
  const size_t shm = smem_bytes(k, LR, mpi);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, k.f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.f, k.nt, shm);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)shm;
  out[3] = k.nt;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return 0;
}
