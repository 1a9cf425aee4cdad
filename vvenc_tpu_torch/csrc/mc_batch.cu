// K8 mc_batch: separable H.266 motion-compensation filter of a batch of
// pre-gathered reference windows at one fractional phase.
//
// Replaces vvenc_tpu/ops/interp.py:183 mc_batch, an XLA program on the
// TPU (one program per phase and block size: shifted slices times the
// phase's taps, summed in int32).  Same arithmetic, bit for bit: windows
// [B, h + n - 1, w + n - 1] int32 (n = 8 luma taps, 4 chroma), output
// [B, h, w] int32, four kinds by phase:
//   0 (0, 0)        the window's centre, copied without a clip;
//   1 frac_y == 0   rows half .. half + h filtered horizontally, as first
//                   and last stage: (acc + off1) >> sh1, clipped to the
//                   bit depth;
//   2 frac_x == 0   columns half .. half + w filtered vertically, first
//                   and last stage, with (sh2, off2), clipped;
//   3 otherwise     every window row filtered horizontally as first, not
//                   last stage (offset -8192 << sh1, no clip) into a
//                   14-bit intermediate, then vertically as last stage
//                   (shift 6 + head room, offset with 8192 << 6), clipped.
// The wrapper computes the taps, shifts and offsets from the reference's
// own rules and passes them as arguments.  The sums are taken in unsigned
// arithmetic, so that they wrap as XLA's int32 does instead of being
// undefined (only their order differs from the reference's, which does not
// matter modulo 2^32); >> on the signed value is arithmetic.
//
// Bound: bytes.  The samples a kind reads are read once and an output
// written once: for every 16x16 luma block of a 1080p picture 25 MB in
// the two-stage kind (7.5 us at 3.35 TB/s), 20 MB in the one-stage kinds,
// 16.5 MB for the copy; against 2n multiply-adds per output sample and
// stage (about a third of that time on the int32 pipe).  The first kernel ran a 256-thread block
// per window, divided by the runtime width for every sample, staged the
// two-stage intermediate in shared memory behind a barrier and read every
// tap through L1 with 4-byte loads (0.016 ms at 1080p 16x16, 47 % of the
// bound).  Design:
// - one instantiation per (ntaps, kind, w) for the widths H.266 uses
//   (luma 4..128, chroma 2..64), so that the tap loops and the row loops
//   unroll and no division by w remains; one generic instantiation with
//   runtime w for every other width;
// - a thread block takes G consecutive windows (about 24 KB) and stages
//   in shared memory what its kind reads, by bulk copies of the tensor
//   memory accelerator (cp.async.bulk, completion on one mbarrier).
//   Kinds 2 and 3 read every window row: the G windows are one contiguous
//   span, staged by one copy.  Kinds 0 and 1 read only rows half .. half +
//   h of each window: one copy a window, into a slot of its own, so the
//   n - 1 rows they do not read stay in device memory.  A bulk copy needs
//   16-byte-aligned addresses and sizes, so each copy covers the 16-byte
//   chunks that hold its span: a tensor that starts 4 bytes off 16-byte
//   alignment (a view such as win[1:]) or a window of an odd size needs
//   no scalar head or tail; the span starts `lead` words into the staged
//   copy, and the few words around it (inside the same aligned chunks, so
//   in the same page) are never read.  Kinds 0 and 2 read w of each row's
//   w + n - 1 words and stage the whole row (a row is 92 bytes at luma
//   16x16, so its middle 64 bytes touch most of its 32-byte sectors
//   anyway): 1.4x the bytes they need at luma 16x16 and chroma 8x8.  The
//   grid is a single wave at 1080p: the resident blocks of an SM keep
//   their copies in flight while the blocks whose data has arrived filter;
// - a thread takes a run of R = 4 columns (2 at w = 2) and a segment of
//   up to S = 8 output rows.  Kind 3 is fused: the thread filters each of
//   the segment's S + n - 1 window rows horizontally at its R columns
//   (R + n - 1 words read once per row) and slides the last n results in
//   registers to emit each vertical output as soon as its n rows are in;
//   no intermediate goes to shared memory and no barrier separates the
//   stages (the segment refilters n - 1 rows of the next one).  Kind 2
//   slides the window samples the same way, kind 1 filters its rows, kind
//   0 copies;
// - outputs go out as 16-byte stores (8 bytes at w = 2) when the output
//   is 16-byte aligned (the wrapper allocates it so), threads of one
//   segment on neighbouring runs;
// - a window too large for shared memory (above about 227 KB, beyond any
//   H.266 block) takes the generic instantiation without staging: the
//   same filter reads the window from device memory.
// tests/test_torch_k8k10_models.py holds the fused column-sliding order
// against the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kS = 8;                        // output rows of a segment
constexpr int kGroupBytes = 24 * 1024;       // staged windows of a block
constexpr int kBarBytes = 16;                // the mbarrier, padded
constexpr int kSmemMax = 227 * 1024;
constexpr int kSlackBytes = 32;              // the aligned chunks' margin

struct Params {
  long long B;
  int w, h, WW, WH, WS;      // WS = WW * WH words a window
  int G, tpw, ncol;          // windows a block, tasks a window, runs a row
  int slot;                  // bytes a staged window's rows take (kinds 0, 1)
  int tx[8], ty[8];
  int sh1, off1, sh2, off2, maxval;
  int vec;                   // out is 16-byte aligned
};

// columns a thread takes: 4, or 2 at w = 2 (w = 0: the generic width)
__host__ __device__ constexpr int run_cols(int W) { return W == 2 ? 2 : 4; }

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

__device__ __forceinline__ int shift_off(unsigned acc, int off, int sh) {
  return (int)(acc + (unsigned)off) >> sh;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival on mbarrier bar that expects `bytes` from bulk copies
__device__ __forceinline__ void expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// copy `bytes` (a multiple of 16) from the 16-byte-aligned src to the
// 16-byte-aligned dst, completing on mbarrier bar
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the 16-byte-aligned chunks [lo, hi) that hold `bytes` bytes from a
__device__ __forceinline__ void cover(const void* a, size_t bytes,
                                      uintptr_t& lo, uintptr_t& hi) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(a);
  lo = u & ~(uintptr_t)15;
  hi = (u + bytes + 15) & ~(uintptr_t)15;
}

// wait for phase 0 of mbarrier bar; a copy that never completes traps
// (about 4 s) instead of hanging the card
__device__ __forceinline__ void mbar_wait0(unsigned bar) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

// R outputs at d (valid of them inside the row); 16- or 8-byte stores
// when the run is whole and the output aligned
template <int W, int R>
__device__ __forceinline__ void store_run(int* d, const int (&o)[R],
                                          int valid, int vec) {
  if constexpr (W > 0) {
    if (vec) {
      if constexpr (R == 4)
        *reinterpret_cast<int4*>(d) = make_int4(o[0], o[1], o[2], o[3]);
      else
        *reinterpret_cast<int2*>(d) = make_int2(o[0], o[1]);
      return;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) d[i] = o[i];
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < valid) d[i] = o[i];
  }
}

// n consecutive words of a window row from column c (a generic width
// reads 0 past the row's end, which only runs past w use)
template <int W, int M>
__device__ __forceinline__ void load_row(const int* row, int c, int ww,
                                         int (&v)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j)
    v[j] = (W > 0 || c + j < ww) ? row[c + j] : 0;
}

// one task: the run of R columns from c0 and the segment of output rows
// from y0 of window s (shared or device memory) into dst (the window's
// output); kinds 0 and 1 read output row y from row y + rofs of s (rofs
// = half for a whole window, 0 for the staged rows half .. half + h)
template <int N, int KIND, int W>
__device__ __forceinline__ void run_task(const int* s, int* dst, int c0,
                                         int y0, int rofs, const Params& p) {
  constexpr int R = run_cols(W), half = N / 2 - 1;
  const int w = W > 0 ? W : p.w;
  const int ww = W > 0 ? W + N - 1 : p.WW;
  const int h = p.h, wh = p.WH;
  const int valid = w - c0;
  if constexpr (KIND == 0 || KIND == 1) {
#pragma unroll
    for (int r = 0; r < kS; ++r) {
      const int y = y0 + r;
      if (y >= h) break;
      int o[R];
      const int* row = s + (y + rofs) * ww;
      if constexpr (KIND == 0) {
        int v[R];
        load_row<W>(row, c0 + half, ww, v);
#pragma unroll
        for (int i = 0; i < R; ++i) o[i] = v[i];
      } else {
        int v[R + N - 1];
        load_row<W>(row, c0, ww, v);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          unsigned acc = 0;
#pragma unroll
          for (int k = 0; k < N; ++k)
            acc += (unsigned)p.tx[k] * (unsigned)v[i + k];
          o[i] = clampi(shift_off(acc, p.off1, p.sh1), p.maxval);
        }
      }
      store_run<W, R>(dst + y * w + c0, o, valid, p.vec);
    }
  } else {
    // the last n rows' values at the run's columns, slid in registers
    // (the unrolled loop names each row's registers statically)
    int hv[kS + N - 1][R];
#pragma unroll
    for (int r = 0; r < kS + N - 1; ++r) {
      const int row = y0 + r;
      if (row < wh) {
        if constexpr (KIND == 2) {
          int v[R];
          load_row<W>(s + row * ww, c0 + half, ww, v);
#pragma unroll
          for (int i = 0; i < R; ++i) hv[r][i] = v[i];
        } else {
          int v[R + N - 1];
          load_row<W>(s + row * ww, c0, ww, v);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            unsigned acc = 0;
#pragma unroll
            for (int k = 0; k < N; ++k)
              acc += (unsigned)p.tx[k] * (unsigned)v[i + k];
            hv[r][i] = shift_off(acc, p.off1, p.sh1);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) hv[r][i] = 0;
      }
      if (r >= N - 1) {
        const int y = row - (N - 1);
        if (y < h) {
          int o[R];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            unsigned acc = 0;
#pragma unroll
            for (int k = 0; k < N; ++k)
              acc += (unsigned)p.ty[k] * (unsigned)hv[r - (N - 1) + k][i];
            o[i] = clampi(shift_off(acc, p.off2, p.sh2), p.maxval);
          }
          store_run<W, R>(dst + y * w + c0, o, valid, p.vec);
        }
      }
    }
  }
}

// a thread block takes windows [g0, g0 + G): staged in shared memory
// (STAGED; kinds 0 and 1 only the rows they read, a window a slot of
// p.slot bytes) or read from device memory, one task a thread
template <int N, int KIND, int W, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads) mc_kernel(
    const int* __restrict__ win, int* __restrict__ out, const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = run_cols(W), half = N / 2 - 1;
  constexpr bool ROWS = KIND < 2;          // only rows half .. half + h
  const long long g0 = (long long)blockIdx.x * p.G;
  const int nb = (int)min((long long)p.G, p.B - g0);
  const int* src = win + g0 * p.WS;
  unsigned char* buf = smem + kBarBytes;
  if constexpr (STAGED) {
    const unsigned bar = smem_u32(smem);
    uintptr_t lo, hi;
    if (threadIdx.x == 0) mbar_init(bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      if constexpr (ROWS) {
        const size_t bytes = (size_t)p.h * p.WW * 4;
        unsigned total = 0;
        for (int g = 0; g < nb; ++g) {
          cover(src + (size_t)g * p.WS + half * p.WW, bytes, lo, hi);
          total += (unsigned)(hi - lo);
        }
        expect_tx(bar, total);
        for (int g = 0; g < nb; ++g) {
          cover(src + (size_t)g * p.WS + half * p.WW, bytes, lo, hi);
          bulk_copy(smem_u32(buf + (size_t)g * p.slot),
                    reinterpret_cast<const void*>(lo), (unsigned)(hi - lo),
                    bar);
        }
      } else {
        cover(src, (size_t)nb * p.WS * 4, lo, hi);
        expect_tx(bar, (unsigned)(hi - lo));
        bulk_copy(smem_u32(buf), reinterpret_cast<const void*>(lo),
                  (unsigned)(hi - lo), bar);
      }
    }
    mbar_wait0(bar);
  }
  const int ntask = nb * p.tpw;
  for (int t = threadIdx.x; t < ntask; t += blockDim.x) {
    const int g = t / p.tpw, rem = t - g * p.tpw;
    const int ncol = W > 0 ? W / R : p.ncol;
    const int seg = rem / ncol, c = rem - seg * ncol;
    const int* s = src + (size_t)g * p.WS;
    int rofs = half;
    if constexpr (STAGED) {
      if constexpr (ROWS) {
        const int* rows = s + half * p.WW;
        s = reinterpret_cast<const int*>(buf + (size_t)g * p.slot) +
            (reinterpret_cast<uintptr_t>(rows) & 15) / 4;
        rofs = 0;
      } else {
        s = reinterpret_cast<const int*>(buf) +
            (reinterpret_cast<uintptr_t>(src) & 15) / 4 + (size_t)g * p.WS;
      }
    }
    run_task<N, KIND, W>(s, out + (size_t)(g0 + g) * p.h * p.w, c * R,
                         seg * kS, rofs, p);
  }
}

template <int N, int KIND>
const void* pick_kind(int w, bool staged) {
  if (!staged) return (const void*)mc_kernel<N, KIND, 0, false>;
  switch (w) {
    case 2:
      if constexpr (N == 4) return (const void*)mc_kernel<N, KIND, 2, true>;
      break;
    case 4: return (const void*)mc_kernel<N, KIND, 4, true>;
    case 8: return (const void*)mc_kernel<N, KIND, 8, true>;
    case 16: return (const void*)mc_kernel<N, KIND, 16, true>;
    case 32: return (const void*)mc_kernel<N, KIND, 32, true>;
    case 64: return (const void*)mc_kernel<N, KIND, 64, true>;
    case 128:
      if constexpr (N == 8) return (const void*)mc_kernel<N, KIND, 128, true>;
      break;
    default: break;
  }
  return (const void*)mc_kernel<N, KIND, 0, true>;
}

template <int N>
const void* pick(int kind, int w, bool staged) {
  switch (kind) {
    case 0: return pick_kind<N, 0>(w, staged);
    case 1: return pick_kind<N, 1>(w, staged);
    case 2: return pick_kind<N, 2>(w, staged);
    default: return pick_kind<N, 3>(w, staged);
  }
}

// the width an instantiation is for: w itself, or 0 (generic)
int inst_width(int ntaps, int w) {
  const bool luma = ntaps == 8;
  switch (w) {
    case 2: return luma ? 0 : 2;
    case 4: case 8: case 16: case 32: case 64: return w;
    case 128: return luma ? 128 : 0;
    default: return 0;
  }
}

struct Launch {
  const void* f;
  Params p;
  int threads;
  size_t shm;
  long long grid;
};

int g_sms[16];

// the launch for B windows; false when the shape overflows the kernel's
// 32-bit indexing
bool plan(long long B, int w, int h, int ntaps, int kind, int sms,
          Launch& L) {
  Params& p = L.p;
  p.B = B;
  p.w = w;
  p.h = h;
  p.WW = w + ntaps - 1;
  p.WH = h + ntaps - 1;
  const long long ws = (long long)p.WW * p.WH;
  if (ws * 4 > 0x7fffffffLL || (long long)w * h > 0x7fffffffLL) return false;
  p.WS = (int)ws;
  const int W = inst_width(ntaps, w);
  const int R = run_cols(W);
  p.ncol = (w + R - 1) / R;
  const long long tpw = (long long)p.ncol * ((h + kS - 1) / kS);
  if (tpw * 4 > 0x7fffffffLL) return false;
  p.tpw = (int)tpw;
  // shared memory a window takes: kinds 0 and 1 its rows half .. half + h
  // in a slot that holds their aligned chunks, kinds 2 and 3 the whole
  // window (the group's span, with one margin for its aligned chunks)
  const bool rows = kind < 2;
  const long long slot = (((long long)h * p.WW * 4 + 15) & ~15LL) + 16;
  const long long wbytes = rows ? slot : ws * 4;
  const long long margin = rows ? 0 : kSlackBytes;
  p.slot = (int)(slot < 0x7fffffffLL ? slot : 0);
  const bool staged = wbytes + margin + kBarBytes <= kSmemMax;
  // G: about kGroupBytes a block, enough tasks for up to 256 threads, and
  // at least four blocks an SM when B allows
  long long G = staged ? kGroupBytes / wbytes : 1;
  const long long by_threads = (kMaxThreads + p.tpw - 1) / p.tpw;
  const long long by_sms = (B + 4LL * sms - 1) / (4LL * sms);
  G = G < by_threads ? G : by_threads;
  G = G < by_sms ? G : by_sms;
  if (G < 1) G = 1;
  if (staged && G * wbytes + margin + kBarBytes > kSmemMax) G = 1;
  if (G * p.tpw > 0x7fffffffLL) return false;
  p.G = (int)G;
  const long long tasks = G * p.tpw;
  L.threads = (int)(tasks >= kMaxThreads ? kMaxThreads
                                         : ((tasks + 31) / 32) * 32);
  L.shm = staged ? (size_t)(kBarBytes + G * wbytes + margin) : 0;
  L.grid = (B + G - 1) / G;
  L.f = ntaps == 8 ? pick<8>(kind, w, staged) : pick<4>(kind, w, staged);
  return L.grid <= 0x7fffffffLL;
}

int set_smem(const void* f, size_t shm) {
  if (shm <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
}

}  // namespace

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// windows [B, h + ntaps - 1, w + ntaps - 1] int32 -> out [B, h, w] int32;
// ntaps 8 or 4 (taps beyond ntaps are ignored); kind 0 copy, 1 horizontal
// only (tx, sh1, off1), 2 vertical only (ty, sh2, off2), 3 both.  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int vt_mc_batch(const void* windows, void* out, long long B, int w,
                           int h, int ntaps, int kind, int tx0, int tx1,
                           int tx2, int tx3, int tx4, int tx5, int tx6,
                           int tx7, int ty0, int ty1, int ty2, int ty3,
                           int ty4, int ty5, int ty6, int ty7, int sh1,
                           int off1, int sh2, int off2, int maxval,
                           void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  if (B <= 0 || B > 0x7fffffffLL || w <= 0 || h <= 0 || kind < 0 ||
      kind > 3 || (ntaps != 8 && ntaps != 4) || sh1 < 0 || sh1 > 31 ||
      sh2 < 0 || sh2 > 31)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& sms = g_sms[dev & 15];
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  Launch L;
  if (!plan(B, w, h, ntaps, kind, sms, L)) return (int)cudaErrorInvalidValue;
  Params& p = L.p;
  const int tx[8] = {tx0, tx1, tx2, tx3, tx4, tx5, tx6, tx7};
  const int ty[8] = {ty0, ty1, ty2, ty3, ty4, ty5, ty6, ty7};
  for (int k = 0; k < 8; ++k) {
    p.tx[k] = k < ntaps ? tx[k] : 0;
    p.ty[k] = k < ntaps ? ty[k] : 0;
  }
  p.sh1 = sh1;
  p.off1 = off1;
  p.sh2 = sh2;
  p.off2 = off2;
  p.maxval = maxval;
  p.vec = ((uintptr_t)out & 15) == 0;
  const int err = set_smem(L.f, L.shm);
  if (err) return err;
  void* args[] = {(void*)&windows, (void*)&out, (void*)&p};
  e = cudaLaunchKernel(L.f, dim3((unsigned)L.grid), dim3(L.threads), args,
                       L.shm, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the resources of the kernel a large batch of h x w blocks at (ntaps,
// kind) launches: out = registers per thread, static and dynamic shared
// memory bytes, threads per block, resident blocks per SM, local memory
// bytes per thread.
extern "C" int vt_mc_batch_attrs(int w, int h, int ntaps, int kind,
                                 int* out) {
  if (w <= 0 || h <= 0 || kind < 0 || kind > 3 || (ntaps != 8 && ntaps != 4))
    return (int)cudaErrorInvalidValue;
  Launch L;
  if (!plan(1LL << 30, w, h, ntaps, kind, 132, L))
    return (int)cudaErrorInvalidValue;
  int e = set_smem(L.f, L.shm);
  if (e) return e;
  cudaFuncAttributes a;
  e = (int)cudaFuncGetAttributes(&a, L.f);
  if (e) return e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, L.f,
                                                         L.threads, L.shm);
  if (e) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)L.shm;
  out[3] = L.threads;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return 0;
}
