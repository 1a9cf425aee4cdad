// K9 full_search_sse: the SSE of each block at every integer displacement
// inside its search area.
//
// Replaces vvenc_tpu/ops/me.py:38 full_search_sse_batch, an XLA program on
// the TPU that computed sum(a^2) + sum(b^2) - 2 corr(a, b) in float32, the
// correlation as a batch-grouped convolution on the matrix unit.  That
// form cancels: at 10 bits its costs are off the exact SSE by up to about
// a hundred (ROADMAP.md section 3).  Here every displacement's SSE is the
// exact integer sum of (area - block)^2, written as its float32 (rounded
// once, to nearest).  blocks [B, h, w], areas [B, ah, aw] int32 -> costs
// [B, ah - h + 1, aw - w + 1] float32.
//
// Bound: operations.  Each of the (2R + 1)^2 displacements of each block
// costs h * w multiply-adds (2.24 G for the 8,040 16x16 blocks of a 1080p
// picture at R = 16) against the inputs read once.  The earlier kernel ran
// one thread per displacement with a 64-bit subtract, multiply and add per
// sample and two shared-memory loads per multiply-add (11x its bound).
//
// Design: a persistent grid (two thread blocks an SM) walks groups of G
// blocks; the next group's blocks and areas are in flight by cp.async
// while the current one is searched, and each group picks its route from
// its samples.
// - The float32 route, when all the group's samples lie in [0, 1023]
//   (data of up to 10 bits; the staged ints become float32 in place):
//   SSE = sum(a^2) + sum(b^2) - 2 sum(a b), all in exact integers.  The
//   correlation runs on the float32 pipe, one fused multiply-add a sample:
//   a partial of 8 products (at most 8 * 1023^2 < 2^23) starts from 2^23,
//   so every partial is an exact integer in [2^23, 2^24) and its bit
//   pattern is 0x4B000000 + the partial.  The window's sum(a^2) comes the
//   same way, per area row and chunk of 8 columns, sliding along the row
//   (the square leaving is taken off before the one entering is added, so
//   every value stays in [2^23, 2^24)).  Each displacement sums
//   bits(a^2) - 2 bits(a b) in uint32; the offsets and sum(b^2) (one sum a
//   block) are added at the end, exact because the SSE of a block of at
//   most 4096 samples of differences within 1023 stays below 2^32.  Each
//   thread owns a patch of SY rows x S columns of displacements: an area
//   row segment loaded once serves the S columns and the SY block rows
//   that meet it, and a block row is read by the whole warp at once.  S
//   (3, 9 or 11) and SY (1 or 3) are chosen per shape so that the patches
//   tile the (2R + 1)^2 grid with little waste (R = 16: 3 x 11 exactly),
//   and the area's row stride so that a warp's segment loads fall on
//   distinct banks, also across the blocks of a group.
// - The integer route otherwise (samples outside [0, 1023], blocks of
//   more than 4096 samples or w not a multiple of 4, or a layout that does
//   not fit): every displacement summed in 64-bit integers from the
//   samples staged in shared memory as int32, one thread per displacement
//   (a group of the persistent grid is staged again; a shape the float
//   route does not take runs a thread block per block, as the earlier
//   kernel did).
// No product or convolution library is involved (cuDNN would round the
// products to TF32).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSpan = 1023;  // the float route's largest sample
constexpr unsigned kMagicBits = 0x4B000000u;   // bits of 2^23
constexpr size_t kSmemMax = 227 * 1024;
constexpr size_t kSmemTarget = 113 * 1024;     // two thread blocks an SM

struct Params {
  long long B;
  int h, w, ah, aw, gh, gw;
  int npx, npy, npatch;  // patches per row / column / block
  int aws;               // staged area row stride (words)
  int G;                 // blocks per group
  int AW, BW;            // words per staged area / block
  int blk_off, bufw;     // a buffer: areas [G][AW], blocks [G][BW] from blk_off
  float inv_na, inv_aw, inv_nk, inv_w;  // 1 / (ah aw), 1 / aw, 1 / (h w), 1 / w
  int threads;
};

// every displacement of blocks [0, nb) of a staged group in 64-bit
// integers: block g's area at area + g * astep (rows of as words), the
// block at blk + g * bstep (rows of w).  |a - b| of two int32 is exact in
// uint32 (__sad), and its square is added by one 32 x 32 -> 64-bit
// multiply-add: the sum's bits equal those of the int64 sum of (a - b)^2
// (modulo 2^64 for any int32 inputs), read back as int64.
__device__ void integer_route(const int* area, int astep, int as,
                              const int* blk, int bstep, const Params& p,
                              int nb, long long b0, float* __restrict__ costs) {
  const int nd = p.gh * p.gw;
  for (int q = threadIdx.x; q < nb * nd; q += blockDim.x) {
    const int g = q / nd, c = q - g * nd;
    const int oy = c / p.gw, ox = c - oy * p.gw;
    const int* ar = area + g * astep + oy * as + ox;
    const int* br = blk + g * bstep;
    unsigned long long s = 0;
    for (int i = 0; i < p.h; ++i, ar += as, br += p.w) {
      for (int j = 0; j < p.w; ++j) {
        const unsigned d = __sad(ar[j], br[j], 0u);
        s += (unsigned long long)d * d;
      }
    }
    costs[(b0 + g) * nd + c] = (float)(long long)s;
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// x / d for 0 <= x < 2^24 from inv = 1 / d (float), corrected to exact
__device__ __forceinline__ int fdiv(int x, int d, float inv) {
  int q = __float2int_rz((float)x * inv);
  const int r = x - q * d;
  q += (r >= d) - (r < 0);
  return q;
}

// n ints of src (per a block, rows of `row`) into dst (a block every words,
// rows of stride rs) by cp.async, neighbouring threads on neighbouring
// samples; the padding is never written
__device__ __forceinline__ void fetch_rows(const int* __restrict__ src,
                                           float* dst, int n, int per,
                                           float inv_per, int row,
                                           float inv_row, int words, int rs) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int g = fdiv(k, per, inv_per), e = k - g * per;
    const int r = fdiv(e, row, inv_row);
    cp_async4(dst + g * words + r * rs + (e - r * row), src + k);
  }
}

// the areas and blocks of group grp into buffer dst (one commit group)
__device__ void fetch(const int* __restrict__ blocks,
                      const int* __restrict__ areas, float* dst,
                      const Params& p, long long grp) {
  const long long b0 = grp * p.G;
  const int nb = (int)min((long long)p.G, p.B - b0);
  const int na = p.ah * p.aw, nk = p.h * p.w;
  fetch_rows(areas + b0 * na, dst, nb * na, na, p.inv_na, p.aw, p.inv_aw,
             p.AW, p.aws);
  fetch_rows(blocks + b0 * nk, dst + p.blk_off, nb * nk, nk, p.inv_nk, p.w,
             p.inv_w, p.BW, p.w);
  asm volatile("cp.async.commit_group;\n" ::);
}

// n staged int32 samples to float32 in place (exact for [0, 2^23): the
// sample's bits or'ed into 2^23, less 2^23); true if one lies outside
// [0, kSpan]
__device__ __forceinline__ bool to_float(float* v, int n) {
  bool out = false;
#pragma unroll 4
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int x = __float_as_int(v[k]);
    out |= (unsigned)x > (unsigned)kSpan;
    v[k] = __int_as_float(x | 0x4B000000) - 8388608.0f;
  }
  return out;
}

template <int CH>
__device__ __forceinline__ void load_block_chunk(const float* src, float* b) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  b[0] = q.x;
  b[1] = q.y;
  b[2] = q.z;
  b[3] = q.w;
  if constexpr (CH == 8) {
    const float4 r = *reinterpret_cast<const float4*>(src + 4);
    b[4] = r.x;
    b[5] = r.y;
    b[6] = r.z;
    b[7] = r.w;
  }
}

template <int S, int SY, int CH>
__global__ void __launch_bounds__(kMaxThreads, 2) fs_kernel(
    const int* __restrict__ blocks, const int* __restrict__ areas,
    float* __restrict__ costs, const Params p) {
  extern __shared__ __align__(16) float fsm[];
  unsigned* const s_bsq = reinterpret_cast<unsigned*>(fsm + 2 * p.bufw);
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const long long ngroups = (p.B + p.G - 1) / p.G;
  const unsigned nchunks = (unsigned)(p.h * (p.w / CH));
  // both buffers zeroed once: the padding stays 0
  for (int k = tid; k < 2 * p.bufw; k += T) fsm[k] = 0.f;
  __syncthreads();
  long long grp = blockIdx.x;
  if (grp < ngroups) fetch(blocks, areas, fsm, p, grp);
  for (int it = 0; grp < ngroups; grp += gridDim.x, ++it) {
    float* const cur = fsm + (it & 1) * p.bufw;
    if (grp + gridDim.x < ngroups) {
      fetch(blocks, areas, fsm + ((it + 1) & 1) * p.bufw, p,
            grp + gridDim.x);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const long long b0 = grp * p.G;
    const int nb = (int)min((long long)p.G, p.B - b0);
    // any sample outside [0, 1023] sends the group to the integer route
    bool out = to_float(cur, nb * p.AW);
    out |= to_float(cur + p.blk_off, nb * p.BW);
    if (__syncthreads_or(out)) {
      // the conversion lost those samples: the group staged again as int32
      fetch(blocks, areas, cur, p, grp);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      integer_route(reinterpret_cast<const int*>(cur), p.AW, p.aws,
                    reinterpret_cast<const int*>(cur + p.blk_off), p.BW, p,
                    nb, b0, costs);
      __syncthreads();
      continue;
    }
    // sum(b^2) of each block, a warp a block
    for (int g = warp; g < nb; g += nw) {
      const float* blk = cur + p.blk_off + g * p.BW;
      unsigned acc = 0;
      for (int k = lane; k < p.h * p.w; k += 32)
        acc += __float2uint_rn(blk[k] * blk[k]);
      acc = __reduce_add_sync(0xffffffffu, acc);
      if (lane == 0) s_bsq[g] = acc;
    }
    __syncthreads();
    // each patch: per area row and chunk of CH columns, the window sums
    // of a^2 of its S positions (sliding, started at 2^23) and, for each
    // block row that meets the area row, the partial correlations (started
    // at 2^23); u += bits(a^2 window) - 2 bits(correlation)
    for (int q = tid; q < nb * p.npatch; q += T) {
      const int g = q / p.npatch, pp = q - g * p.npatch;
      const int py = pp / p.npx, px = pp - py * p.npx;
      const int oy0 = py * SY, ox0 = px * S;
      const float* A = cur + g * p.AW + oy0 * p.aws + ox0;
      const float* Bk = cur + p.blk_off + g * p.BW;
      unsigned u[SY][S];
#pragma unroll
      for (int sy = 0; sy < SY; ++sy)
#pragma unroll
        for (int s = 0; s < S; ++s) u[sy][s] = 0;
      for (int r = 0; r < p.h + SY - 1; ++r) {
        const float* Ar = A + r * p.aws;
        for (int jc = 0; jc < p.w; jc += CH) {
          float seg[CH + S - 1];
#pragma unroll
          for (int k = 0; k < CH + S - 1; ++k) seg[k] = Ar[jc + k];
          unsigned wq[S];
          {
            float f = __fmaf_rn(seg[0], seg[0], 8388608.0f);
#pragma unroll
            for (int k = 1; k < CH; ++k) f = __fmaf_rn(seg[k], seg[k], f);
            wq[0] = __float_as_uint(f);
#pragma unroll
            for (int s = 1; s < S; ++s) {
              f = __fmaf_rn(-seg[s - 1], seg[s - 1], f);
              f = __fmaf_rn(seg[s + CH - 1], seg[s + CH - 1], f);
              wq[s] = __float_as_uint(f);
            }
          }
#pragma unroll
          for (int sy = 0; sy < SY; ++sy) {
            const int i = r - sy;
            if (i < 0 || i >= p.h) continue;
            float b[CH];
            load_block_chunk<CH>(Bk + i * p.w + jc, b);
#pragma unroll
            for (int s = 0; s < S; ++s) {
              float acc = __fmaf_rn(seg[s], b[0], 8388608.0f);
#pragma unroll
              for (int k = 1; k < CH; ++k)
                acc = __fmaf_rn(seg[k + s], b[k], acc);
              u[sy][s] += wq[s] - 2u * __float_as_uint(acc);
            }
          }
        }
      }
      // sum over the chunks of (2^23 + w) - 2 (2^23 + c) = box - 2 corr -
      // nchunks 2^23 (bits), so SSE = u + nchunks bits(2^23) + sum(b^2)
      const unsigned base = nchunks * kMagicBits + s_bsq[g];
      float* outp = costs + (b0 + g) * p.gh * p.gw;
#pragma unroll
      for (int sy = 0; sy < SY; ++sy)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int oy = oy0 + sy, ox = ox0 + s;
          if (oy < p.gh && ox < p.gw)
            outp[oy * p.gw + ox] = __uint2float_rn(u[sy][s] + base);
        }
    }
    __syncthreads();   // cur is fetched into again two groups on
  }
}

// the integer route alone, one block per thread block (shapes the float
// route does not take): the area [ah, aw] and the block [h, w] staged
__global__ void __launch_bounds__(kMaxThreads) fs_int_kernel(
    const int* __restrict__ blocks, const int* __restrict__ areas,
    float* __restrict__ costs, const Params p) {
  extern __shared__ int ism[];
  const long long b = blockIdx.x;
  const int na = p.ah * p.aw, nk = p.h * p.w;
  for (int k = threadIdx.x; k < na; k += blockDim.x)
    ism[k] = __ldg(areas + b * na + k);
  for (int k = threadIdx.x; k < nk; k += blockDim.x)
    ism[na + k] = __ldg(blocks + b * nk + k);
  __syncthreads();
  integer_route(ism, 0, p.aw, ism + na, 0, p, 1, b, costs);
}

// the patch widths the float route is built for
constexpr int kS[3] = {3, 9, 11};

struct Plan {
  Params p;
  const void* f;
  size_t shm;
};

template <int S, int SY>
const void* pick_ch(int ch) {
  return ch == 8 ? (const void*)fs_kernel<S, SY, 8>
                 : (const void*)fs_kernel<S, SY, 4>;
}

const void* pick(int S, int SY, int ch) {
  if (S == 3) return SY == 3 ? pick_ch<3, 3>(ch) : pick_ch<3, 1>(ch);
  if (S == 9) return SY == 3 ? pick_ch<9, 3>(ch) : pick_ch<9, 1>(ch);
  return SY == 3 ? pick_ch<11, 3>(ch) : pick_ch<11, 1>(ch);
}

int up(int a, int b) { return (a + b - 1) / b; }

// the float route's layout for patches of SY rows x S columns: G, the
// threads, two buffers; false if one block does not fit
bool float_layout(Params& p, int S, int SY, long long B) {
  p.npx = up(p.gw, S);
  p.npy = up(p.gh, SY);
  p.npatch = p.npx * p.npy;
  const int ahs = p.npy * SY + p.h - 1;    // rows a patch may read
  // SY * aws = S * npx (mod 32): a warp's consecutive patches of a block
  // load their segments from distinct banks (S odd); AW = S * npatch
  // (mod 32) continues that across the blocks of a group
  const int base = p.npx * S + p.w - 1;
  const int target = (S * p.npx * (SY == 3 ? 11 : 1)) & 31;  // 3 * 11 = 1
  p.aws = base + ((target - base) % 32 + 32) % 32;
  const int aw0 = ahs * p.aws;
  p.AW = aw0 + ((S * p.npatch - aw0) % 32 + 32) % 32;
  p.BW = p.h * p.w + 4;                    // float4 rows, banks apart
  const size_t per = 2 * ((size_t)p.AW + p.BW + 1) * 4;   // two buffers
  if (per + 64 > kSmemMax) return false;
  long long G = kMaxThreads / p.npatch;
  G = G < 1 ? 1 : G;
  const long long fit = (long long)((kSmemTarget - 64) / per);
  G = G < fit ? G : (fit < 1 ? 1 : fit);
  G = G < B ? G : B;
  p.G = (int)G;
  p.inv_na = 1.0f / (p.ah * p.aw);
  p.inv_aw = 1.0f / p.aw;
  p.inv_nk = 1.0f / (p.h * p.w);
  p.inv_w = 1.0f / p.w;
  p.blk_off = (p.G * p.AW + 3) & ~3;       // 16-byte aligned
  p.bufw = (p.blk_off + p.G * p.BW + 3) & ~3;
  const int lanes = p.G * p.npatch;
  p.threads = lanes >= kMaxThreads ? kMaxThreads : up(lanes, 32) * 32;
  return true;
}

bool plan_for(long long B, int h, int w, int ah, int aw, Plan& pl) {
  Params& p = pl.p;
  p.B = B;
  p.h = h;
  p.w = w;
  p.ah = ah;
  p.aw = aw;
  p.gh = ah - h + 1;
  p.gw = aw - w + 1;
  if ((long long)h * w <= 4096 && w % 4 == 0) {
    // S: the fewest instructions per row of patches, a fused multiply-add
    // for each slot and sample of a chunk, a load for each segment value
    const int ch = w % 8 == 0 ? 8 : 4;
    auto instr = [&](int s) { return up(p.gw, s) * (ch * s + ch + s - 1); };
    int S = kS[0];
    for (int s : kS)
      if (instr(s) <= instr(S)) S = s;
    Params p3 = p;
    if (float_layout(p3, S, 3, B) && p3.G * p3.npatch >= 128) {
      p = p3;
      pl.f = pick(S, 3, ch);
      pl.shm = ((size_t)2 * p.bufw + p.G) * 4;
      return true;
    }
    if (float_layout(p, S, 1, B)) {
      pl.f = pick(S, 1, ch);
      pl.shm = ((size_t)2 * p.bufw + p.G) * 4;
      return true;
    }
  }
  p.G = 1;
  p.threads = kMaxThreads;
  pl.f = (const void*)fs_int_kernel;
  // the earlier kernel's limit: block and area within the shared memory
  // of a thread block
  pl.shm = ((size_t)ah * aw + (size_t)h * w) * 4;
  return pl.shm <= kSmemMax;
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// blocks [B, h, w], areas [B, ah, aw] int32 (ah >= h, aw >= w) -> costs
// [B, ah - h + 1, aw - w + 1] float32; block and area together must fit
// the 227 KB of shared memory a thread block can use.  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_full_search_sse(const void* blocks, const void* areas,
                                  void* costs, long long B, int h, int w,
                                  int ah, int aw, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (B <= 0 || B > 0x7fffffffLL || h <= 0 || w <= 0 || ah < h || aw < w)
    return (int)cudaErrorInvalidValue;
  Plan pl{};
  if (!plan_for(B, h, w, ah, aw, pl)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      pl.f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.shm);
  if (e != cudaSuccess) return (int)e;
  // the float route: a persistent grid of two thread blocks an SM walks
  // the groups; the integer route alone: a thread block a block
  long long grid = (B + pl.p.G - 1) / pl.p.G;
  if (pl.f != (const void*)fs_int_kernel) {
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    grid = grid < 2LL * sms ? grid : 2LL * sms;
  }
  void* args[] = {(void*)&blocks, (void*)&areas, (void*)&costs,
                  (void*)&pl.p};
  e = cudaLaunchKernel(pl.f, dim3((unsigned)grid), dim3(pl.p.threads), args,
                       pl.shm,
                       (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the resources of the kernel for an h x w block in an ah x aw area: out =
// registers per thread, static and dynamic shared memory bytes, threads
// per block, resident blocks per SM, local memory bytes per thread.
extern "C" int vt_full_search_attrs(int h, int w, int ah, int aw, int* out) {
  if (h <= 0 || w <= 0 || ah < h || aw < w) return (int)cudaErrorInvalidValue;
  Plan pl{};
  if (!plan_for(1 << 20, h, w, ah, aw, pl)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      pl.f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.shm);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, pl.f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pl.f,
                                                    pl.p.threads, pl.shm);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)pl.shm;
  out[3] = pl.p.threads;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return 0;
}
