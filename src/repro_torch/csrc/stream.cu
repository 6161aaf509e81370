// STREAM suite for Hopper (sm_90a): copy, scale, add, triad, write, read.
//
// Replaces the six Pallas TPU kernels of repro/kernels/stream/stream.py:
// stream_copy (:53), stream_scale (:61), stream_add (:72), stream_triad
// (:80), stream_write (:91) and stream_read (:103). On the TPU each is a
// 1-D grid over (block_rows, cols) tiles streamed HBM -> VMEM -> HBM.
//
// What bounds it. Every op does at most two arithmetic operations per
// element against 4 to 12 bytes moved, far below the card's ~295
// operations per byte: the bound is bytes, the HBM rate (3.35 TB/s on the
// H100 SXM data sheet), or the 50 MB L2's rate for buffers that fit there.
// The design therefore only has to keep enough bytes in flight:
//   * elementwise ops: one grid-stride loop over the flat buffer, each
//     thread moving 16 bytes per access (float4 / 8 bf16) when all pointers
//     are 16-byte aligned, a scalar loop for the tail; the grid is capped at
//     16 blocks of 256 threads per SM, so each thread walks several vectors;
//   * read: one block of 1024 threads per row block (the block's elements
//     are contiguous), an f32 accumulator per thread over 16-byte loads,
//     then a warp-shuffle and shared-memory tree; each output belongs to
//     one block, so no pass across blocks is needed.
// The row-block structure of the TPU kernels only matters for read; the
// wrappers refuse a row count that block_rows does not divide, where the
// reference kernels silently leave the ragged tail unwritten.
//
// Rounding matches the plain PyTorch versions: the scalar x arrives
// already rounded to the array's dtype; f32 triad is __fmul_rn then
// __fadd_rn (no contraction into one FMA); bf16 results are computed in
// f32 and rounded to bf16 after each operation, as eager PyTorch does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Op { COPY = 0, SCALE = 1, ADD = 2, TRIAD = 3, WRITE = 4 };

constexpr int EW_THREADS = 256;
constexpr int EW_BLOCKS_PER_SM = 16;
constexpr int READ_THREADS = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// one element of op OP; x is already a value of T (passed as f32)
template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b, float x) {
    if (OP == COPY) return a;
    if (OP == WRITE) return from_f32<T>(x);
    if (OP == SCALE) return from_f32<T>(__fmul_rn(to_f32(a), x));
    if (OP == ADD) return from_f32<T>(__fadd_rn(to_f32(a), to_f32(b)));
    // TRIAD: x*a rounded to T, then + b rounded to T
    T p = from_f32<T>(__fmul_rn(x, to_f32(a)));
    return from_f32<T>(__fadd_rn(to_f32(p), to_f32(b)));
}

template <typename T, int OP>
__global__ void __launch_bounds__(EW_THREADS)
stream_ew_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ o, float x, long long n, int vec) {
    constexpr int V = 16 / sizeof(T);
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nv = vec ? n / V : 0;
    const bool reads_a = OP != WRITE;
    const bool reads_b = OP == ADD || OP == TRIAD;
    for (long long i = tid; i < nv; i += stride) {
        uint4 ra = make_uint4(0, 0, 0, 0), rb = make_uint4(0, 0, 0, 0), ro;
        if (reads_a) ra = reinterpret_cast<const uint4*>(a)[i];
        if (reads_b) rb = reinterpret_cast<const uint4*>(b)[i];
        const T* pa = reinterpret_cast<const T*>(&ra);
        const T* pb = reinterpret_cast<const T*>(&rb);
        T* po = reinterpret_cast<T*>(&ro);
#pragma unroll
        for (int j = 0; j < V; ++j) po[j] = apply<T, OP>(pa[j], pb[j], x);
        reinterpret_cast<uint4*>(o)[i] = ro;
    }
    for (long long e = nv * V + tid; e < n; e += stride) {
        T va = reads_a ? a[e] : from_f32<T>(0.f);
        T vb = reads_b ? b[e] : from_f32<T>(0.f);
        o[e] = apply<T, OP>(va, vb, x);
    }
}

// one block per row block of `block_elems` contiguous elements
template <typename T>
__global__ void __launch_bounds__(READ_THREADS)
stream_read_kernel(const T* __restrict__ a, T* __restrict__ o,
                   long long block_elems, int vec) {
    constexpr int V = 16 / sizeof(T);
    const T* base = a + (long long)blockIdx.x * block_elems;
    float acc = 0.f;
    const long long nv = vec ? block_elems / V : 0;
    for (long long i = threadIdx.x; i < nv; i += READ_THREADS) {
        uint4 r = reinterpret_cast<const uint4*>(base)[i];
        const T* p = reinterpret_cast<const T*>(&r);
#pragma unroll
        for (int j = 0; j < V; ++j) acc += to_f32(p[j]);
    }
    for (long long e = nv * V + threadIdx.x; e < block_elems; e += READ_THREADS)
        acc += to_f32(base[e]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    __shared__ float warp_sums[READ_THREADS / 32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = warp_sums[lane];             // READ_THREADS / 32 == 32 lanes
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) o[blockIdx.x] = from_f32<T>(acc);
    }
}

int ew_grid(long long work) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            sms = 132;
    }
    long long blocks = (work + EW_THREADS - 1) / EW_THREADS;
    long long cap = (long long)sms * EW_BLOCKS_PER_SM;
    if (blocks > cap) blocks = cap;
    return blocks < 1 ? 1 : (int)blocks;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T, int OP>
int launch_ew(const void* a, const void* b, void* o, float x, long long n,
              cudaStream_t st) {
    constexpr int V = 16 / sizeof(T);
    const int vec = aligned16(o) && (a == nullptr || aligned16(a)) &&
                    (b == nullptr || aligned16(b));
    const long long work = vec ? n / V + (n % V) : n;
    stream_ew_kernel<T, OP><<<ew_grid(work), EW_THREADS, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(o), x, n, vec);
    return (int)cudaGetLastError();
}

template <int OP>
int dispatch_ew(const void* a, const void* b, void* o, float x, long long n,
                int dtype, void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_ew<float, OP>(a, b, o, x, n, st);
    if (dtype == 1) return launch_ew<__nv_bfloat16, OP>(a, b, o, x, n, st);
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_read(const void* a, void* o, long long n_blocks,
                long long block_elems, cudaStream_t st) {
    constexpr int V = 16 / sizeof(T);
    const int vec = aligned16(a) && block_elems % V == 0;
    stream_read_kernel<T><<<(unsigned)n_blocks, READ_THREADS, 0, st>>>(
        static_cast<const T*>(a), static_cast<T*>(o), block_elems, vec);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. n: elements. Each returns the
// cudaError_t of the launch (0 on success).
extern "C" int stream_copy(const void* a, void* o, long long n, int dtype,
                           void* stream) {
    return dispatch_ew<COPY>(a, nullptr, o, 0.f, n, dtype, stream);
}

extern "C" int stream_scale(const void* a, void* o, float x, long long n,
                            int dtype, void* stream) {
    return dispatch_ew<SCALE>(a, nullptr, o, x, n, dtype, stream);
}

extern "C" int stream_add(const void* a, const void* b, void* o, long long n,
                          int dtype, void* stream) {
    return dispatch_ew<ADD>(a, b, o, 0.f, n, dtype, stream);
}

extern "C" int stream_triad(const void* a, const void* b, void* o, float x,
                            long long n, int dtype, void* stream) {
    return dispatch_ew<TRIAD>(a, b, o, x, n, dtype, stream);
}

extern "C" int stream_write(void* o, float x, long long n, int dtype,
                            void* stream) {
    return dispatch_ew<WRITE>(nullptr, nullptr, o, x, n, dtype, stream);
}

extern "C" int stream_read(const void* a, void* o, long long n_blocks,
                           long long block_elems, int dtype, void* stream) {
    if (n_blocks <= 0 || n_blocks > 0x7fffffffLL || block_elems <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_read<float>(a, o, n_blocks, block_elems, st);
    if (dtype == 1)
        return launch_read<__nv_bfloat16>(a, o, n_blocks, block_elems, st);
    return (int)cudaErrorInvalidValue;
}
