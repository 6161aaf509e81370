// Designs of the STREAM elementwise kernel that were tried and not kept,
// as a yardstick for stream_ew_kernel in csrc/stream.cu (run by
// benchmarks/stream_designs.py, never by the port): U independent 16-byte
// accesses a thread and input (U = 1, 2, 4), all issued before the first
// store, each with the evict-first hints (ld.global.cs / st.global.cs) or
// the default cache policy; one pass of ceil(n / (256 U 4)) blocks, no
// grid stride. f32 only, n a multiple of 4, every pointer 16-byte
// aligned. The rounding is the kernel's: __fmul_rn then __fadd_rn.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { COPY = 0, SCALE = 1, ADD = 2, TRIAD = 3, WRITE = 4 };

constexpr int THREADS = 256;

template <int OP>
__device__ __forceinline__ float apply(float a, float b, float x) {
    if (OP == COPY) return a;
    if (OP == WRITE) return x;
    if (OP == SCALE) return __fmul_rn(a, x);
    if (OP == ADD) return __fadd_rn(a, b);
    return __fadd_rn(__fmul_rn(x, a), b);
}

template <bool CS>
__device__ __forceinline__ float4 load(const float4* p) {
    if constexpr (CS) return __ldcs(p);
    else return *p;
}

template <bool CS>
__device__ __forceinline__ void store(float4* p, float4 v) {
    if constexpr (CS) __stcs(p, v);
    else *p = v;
}

template <int OP, int U, bool CS>
__global__ void __launch_bounds__(THREADS)
stream_design_kernel(const float4* __restrict__ a,
                     const float4* __restrict__ b, float4* __restrict__ o,
                     float x, long long items) {
    constexpr bool reads_a = OP != WRITE;
    constexpr bool reads_b = OP == ADD || OP == TRIAD;
    const long long i0 = (long long)blockIdx.x * (THREADS * U) + threadIdx.x;
    float4 ra[U] = {}, rb[U] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const long long i = i0 + u * THREADS;
        if (i < items) {
            if (reads_a) ra[u] = load<CS>(a + i);
            if (reads_b) rb[u] = load<CS>(b + i);
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const long long i = i0 + u * THREADS;
        if (i < items)
            store<CS>(o + i, make_float4(
                apply<OP>(ra[u].x, rb[u].x, x), apply<OP>(ra[u].y, rb[u].y, x),
                apply<OP>(ra[u].z, rb[u].z, x),
                apply<OP>(ra[u].w, rb[u].w, x)));
    }
}

template <int OP, int U, bool CS>
int launch(const float* a, const float* b, float* o, float x, long long n,
           cudaStream_t st) {
    const long long items = n / 4;
    const long long blocks = (items + THREADS * U - 1) / (THREADS * U);
    stream_design_kernel<OP, U, CS><<<(unsigned)blocks, THREADS, 0, st>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<const float4*>(b),
        reinterpret_cast<float4*>(o), x, items);
    return (int)cudaGetLastError();
}

template <int OP>
int by_design(int unroll, int cs, const float* a, const float* b, float* o,
              float x, long long n, cudaStream_t st) {
    if (unroll == 1) return cs ? launch<OP, 1, true>(a, b, o, x, n, st)
                               : launch<OP, 1, false>(a, b, o, x, n, st);
    if (unroll == 2) return cs ? launch<OP, 2, true>(a, b, o, x, n, st)
                               : launch<OP, 2, false>(a, b, o, x, n, st);
    if (unroll == 4) return cs ? launch<OP, 4, true>(a, b, o, x, n, st)
                               : launch<OP, 4, false>(a, b, o, x, n, st);
    return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// op: 0 copy, 1 scale, 2 add, 3 triad, 4 write (o = x); unroll: 1, 2 or
// 4; cs: 1 for the evict-first hints. a and b may be null where the op
// reads neither. Returns the cudaError_t of the launch.
extern "C" int stream_design(int op, int unroll, int cs, const float* a,
                             const float* b, float* o, float x, long long n,
                             void* stream) {
    if (n <= 0 || n % 4 != 0 || n / 4 > 0x7fffffffLL || !aligned16(o) ||
        !aligned16(a) || !aligned16(b))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (op) {
    case COPY: return by_design<COPY>(unroll, cs, a, b, o, x, n, st);
    case SCALE: return by_design<SCALE>(unroll, cs, a, b, o, x, n, st);
    case ADD: return by_design<ADD>(unroll, cs, a, b, o, x, n, st);
    case TRIAD: return by_design<TRIAD>(unroll, cs, a, b, o, x, n, st);
    case WRITE: return by_design<WRITE>(unroll, cs, a, b, o, x, n, st);
    }
    return (int)cudaErrorInvalidValue;
}
