// Float matmul with a float32 accumulator, result in the input dtype.
//
// Replaces: src/repro/kernels/qmatmul.py::fmatmul (Pallas TPU kernel
// _fmatmul_kernel). It runs the float FULLY_CONNECTED layers of the
// compiled engine's kernel route (a float graph with use_kernels=True),
// through kernels/ops.py::fmatmul, which pads K and N only to whole 16-byte
// rows (nothing at all for the speech model's 8 x 4000 x 4 FC).
//
// What bounds it on an H100: float32 FMAs on the CUDA cores (67 TFLOP/s;
// never TF32, the reference's tolerance is 1e-5). At 128 x 4096 x 128 that
// is 134 MFLOP / 67 TFLOP/s = 2.0 us, above the 4.3 MB / 3.35 TB/s = 1.3 us
// the operands need. The engine's real call (8 x 4000 x 4, 256 kFLOP) is
// bounded by the launch.
//
// Design:
// * Split K. A 64x64 output tile alone gives a small product a handful of
//   blocks (4 at 128 x 4096 x 128 for 132 SMs). The wrapper cuts a K of
//   more than 4 steps of 32 into S slices (at least 2 steps each) so that
//   tiles x S fills about one wave; block (tile, s) walks only its slice.
// * Deterministic reduction, no atomics. With S > 1 each block writes its
//   float32 partial tile to a workspace (S, M, N) that the wrapper allocates;
//   a second kernel sums the S partials of each output in a fixed order
//   (one warp per four outputs: lane l takes s = l, l + 32, ..., then a
//   fixed shuffle tree, and lane 0 rounds once to the output dtype). The
//   same inputs give the same bits on every run. With S = 1 the first
//   kernel writes the output itself. The second kernel is launched as a
//   programmatic dependent of the first, so its launch overlaps the first's
//   tail; it reads nothing before the first has finished.
// * Pipelined loads. Each 64x32 x tile and 32x64 w tile is copied with
//   cp.async, 16 bytes a thread, into a ring of four shared-memory buffers,
//   three K tiles ahead of the FMAs (a slice of up to 4 tiles is in flight
//   at once). Rows are padded by 16 bytes, so the compute reads are free of
//   bank conflicts.
// * Ragged edges. Copies of rows >= M, columns >= N or k past the slice
//   zero-fill (cp.async with source size 0), and stores are masked, so any
//   M works. K and N must be multiples of 16 bytes / element size (whole
//   16-byte chunks): 4 for float32, 8 for bfloat16.
// * Arithmetic. 256 threads; each owns 4 x 4 outputs (rows ty + 16*i,
//   columns 4*tx + j) and accumulates with __fmaf_rn. A warp skips the row
//   sets that lie wholly past M (the engine's call has M = 1 .. 8 of a
//   64-row tile), with the count as a template argument so the accumulators
//   stay in registers. bfloat16 operands are widened with __bfloat162float
//   when read from shared memory (a product of two bf16 values is exact in
//   float32), and the result is rounded once (__float2bfloat16_rn).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 4;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive elements from shared memory, widened (one vector load)
__device__ __forceinline__ void load4(const float* src, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src,
                                      float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
struct Tiles {
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int XLD = BK + EPC;        // padded row lengths
  static constexpr int WLD = BN + EPC;
  T x[STAGES][BM][XLD];
  T w[STAGES][BK][WLD];
};

// One staged K tile into the accumulators, for the first LIVE of the
// thread's four rows.
template <int LIVE, typename T>
__device__ __forceinline__ void mac_step(const Tiles<T>& sm, int st, int ty,
                                         int tx, float (&acc)[4][4]) {
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    float b[4];
    load4(&sm.w[st][kk][tx * 4], b);
#pragma unroll
    for (int i = 0; i < LIVE; ++i) {
      const float a = widen(sm.x[st][ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a, b[j], acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fmatmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, float* __restrict__ partial, int M, int N,
               int K, int kslice) {
  constexpr int EPC = Tiles<T>::EPC;
  extern __shared__ __align__(16) unsigned char fsmem[];
  Tiles<T>& sm = *reinterpret_cast<Tiles<T>*>(fsmem);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // see the header note

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4*tx .. 4*tx + 3
  const int ty = tid / 16;  // rows ty + 16*i, i < 4
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kslice;
  const int kend = min(K, kbeg + kslice);
  const int steps = (kend - kbeg + BK - 1) / BK;
  // row sets of this warp that reach below M: its lanes share the rows'
  // 16-row phase (ty = 2*warp, 2*warp + 1), so the count is warp-uniform
  const int live = min(4, max(0, (M - m0 - (tid / 32) * 2 + 15) / 16));

  auto load = [&](int stage, int k0) {
    constexpr int XCH = BM * BK / EPC;  // 16-byte chunks of the x tile
#pragma unroll
    for (int c = tid; c < XCH; c += THREADS) {
      const int r = c / (BK / EPC);
      const int kc = (c % (BK / EPC)) * EPC;
      const bool ok = m0 + r < M && k0 + kc < kend;
      cp_async16(&sm.x[stage][r][kc],
                 ok ? x + static_cast<size_t>(m0 + r) * K + k0 + kc : x, ok);
    }
    constexpr int WCH = BK * BN / EPC;
#pragma unroll
    for (int c = tid; c < WCH; c += THREADS) {
      const int r = c / (BN / EPC);
      const int nc = (c % (BN / EPC)) * EPC;
      const bool ok = k0 + r < kend && n0 + nc < N;
      cp_async16(&sm.w[stage][r][nc],
                 ok ? w + static_cast<size_t>(k0 + r) * N + n0 + nc : w, ok);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, kbeg + s * BK);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();  // tile s has landed (this thread's) ...
    __syncthreads();              // ... everyone's, and tile s-1 is consumed
    const int next = s + STAGES - 1;
    if (next < steps) load(next % STAGES, kbeg + next * BK);
    cp_async_commit();
    const int st = s % STAGES;
    switch (live) {  // a compile-time row count keeps acc in registers
      case 4: mac_step<4>(sm, st, ty, tx, acc); break;
      case 3: mac_step<3>(sm, st, ty, tx, acc); break;
      case 2: mac_step<2>(sm, st, ty, tx, acc); break;
      case 1: mac_step<1>(sm, st, ty, tx, acc); break;
      default: break;
    }
  }
  asm volatile("griddepcontrol.launch_dependents;");

  const int n = n0 + tx * 4;
  if (n >= N) return;  // N is a multiple of 4: four columns in or out
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) break;
    if (gridDim.z == 1) {
      store4(out + static_cast<size_t>(m) * N + n, acc[i]);
    } else {
      store4(partial + (static_cast<size_t>(blockIdx.z) * M + m) * N + n,
             acc[i]);
    }
  }
}

// out = the sum of the S partials: one warp per four consecutive outputs;
// lane l adds s = l, l + 32, ... in that order, a fixed shuffle tree adds
// the lanes, and lane 0 rounds and stores
template <typename T>
__global__ void __launch_bounds__(THREADS)
fmatmul_reduce(const float* __restrict__ partial, T* __restrict__ out,
               int quads, int S, size_t plane) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int q = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (q >= quads) return;  // whole warps
  const float4* p = reinterpret_cast<const float4*>(partial) + q;
  const size_t step = plane / 4;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = lane; s < S; s += 32) {
    const float4 t = p[s * step];
    v[0] = __fadd_rn(v[0], t.x);
    v[1] = __fadd_rn(v[1], t.y);
    v[2] = __fadd_rn(v[2], t.z);
    v[3] = __fadd_rn(v[3], t.w);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = __fadd_rn(v[e], __shfl_xor_sync(0xffffffffu, v[e], off));
    }
  }
  if (lane == 0) store4(out + static_cast<size_t>(q) * 4, v);
}

template <typename K, typename... Args>
cudaError_t launch_pdl(K kernel, dim3 grid, int smem, cudaStream_t stream,
                       Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
int launch(const void* x, const void* w, void* out, void* partial, int M,
           int N, int K, int S, int kslice, cudaStream_t stream) {
  constexpr int bytes = sizeof(Tiles<T>);
  static const cudaError_t set = cudaFuncSetAttribute(  // once per dtype
      fmatmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  launch_pdl(fmatmul_kernel<T>,
             dim3((N + BN - 1) / BN, (M + BM - 1) / BM, S), bytes, stream,
             static_cast<const T*>(x), static_cast<const T*>(w),
             static_cast<T*>(out), static_cast<float*>(partial), M, N, K,
             kslice);
  if (S > 1) {
    const int quads = M * N / 4;
    launch_pdl(fmatmul_reduce<T>,
               dim3((quads * 32 + THREADS - 1) / THREADS), 0, stream,
               static_cast<const float*>(partial), static_cast<T*>(out),
               quads, S, static_cast<size_t>(M) * N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), w (K, N), out (M, N): all float32 (bf16 == 0) or all bfloat16
// (bf16 == 1), row-major, contiguous, 16-byte aligned; K and N multiples of
// 16 bytes / element size; M any positive size. S K-slices of kslice
// (a multiple of 32) elements each; with S > 1, partial is a float32
// workspace of S * M * N elements (else unused). The Python wrapper checks
// and chooses S. Returns cudaGetLastError() after the launches.
extern "C" int repro_fmatmul(const void* x, const void* w, void* out,
                             void* partial, int M, int N, int K, int S,
                             int kslice, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, w, out, partial, M, N, K, S, kslice, s)
              : launch<float>(x, w, out, partial, M, N, K, S, kslice, s);
}
