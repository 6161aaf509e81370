// The port's first fma_f32 loop, kept as a yardstick for the kernel in
// csrc/dpa_matmul.cu (run by benchmarks/fma_f32_designs.py, never by the
// port): one shared buffer of 8-deep K slices, the next slice staged in
// registers, A transposed into shared memory by scalar stores, 16 x 16
// threads of TM x TM outputs (rows (i/4) 64 + 4 ty + i%4), so a (16 TM)^2
// block tile. Its first form had TM = 8 only; TM = 4 gives the 64x64 tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, F_BK = 8;

__device__ __forceinline__ uint4 load4(const float* __restrict__ base,
                                       long long row, long long ld,
                                       bool row_ok, int col, int ncols,
                                       bool vec) {
    uint4 r = make_uint4(0, 0, 0, 0);
    if (!row_ok || col >= ncols) return r;
    const float* p = base + row * ld + col;
    if (vec && col + 4 <= ncols) return *reinterpret_cast<const uint4*>(p);
    float* out = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (col + j < ncols) out[j] = p[j];
    return r;
}

template <int TM>
__global__ void __launch_bounds__(THREADS)
fma_f32_first_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K, int vec_a,
                     int vec_b, int vec_c) {
    constexpr int T = 16 * TM;
    constexpr int LOADERS = T * F_BK / 4;  // threads holding a 16-byte chunk
    __shared__ __align__(16) float As[F_BK][T];       // A transposed
    __shared__ __align__(16) float Bs[F_BK][T];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * T, n0 = blockIdx.x * T;
    const bool loads = LOADERS >= THREADS || tid < LOADERS;  // all at TM 8
    const int a_row = tid / 2, a_col = (tid % 2) * 4;
    const int b_row = tid / (T / 4), b_col = (tid % (T / 4)) * 4;
    float acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
    uint4 ra, rb;
    auto fetch = [&](int k0) {
        if (!loads) return;
        ra = load4(A, m0 + a_row, K, m0 + a_row < M, k0 + a_col, K, vec_a);
        rb = load4(B, k0 + b_row, N, k0 + b_row < K, n0 + b_col, N, vec_b);
    };
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += F_BK) {
        if (loads) {
            const float* av = reinterpret_cast<const float*>(&ra);
#pragma unroll
            for (int j = 0; j < 4; ++j) As[a_col + j][a_row] = av[j];
            *reinterpret_cast<uint4*>(&Bs[b_row][b_col]) = rb;
        }
        __syncthreads();
        if (k0 + F_BK < K) fetch(k0 + F_BK);
#pragma unroll
        for (int kk = 0; kk < F_BK; ++kk) {
            float ar[TM], br[TM];
#pragma unroll
            for (int h = 0; h < TM / 4; ++h) {
                *reinterpret_cast<float4*>(&ar[h * 4]) =
                    *reinterpret_cast<const float4*>(&As[kk][h * 64 + ty * 4]);
                *reinterpret_cast<float4*>(&br[h * 4]) =
                    *reinterpret_cast<const float4*>(&Bs[kk][h * 64 + tx * 4]);
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TM; ++j)
                    acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
        if (m >= M) continue;
#pragma unroll
        for (int h = 0; h < TM / 4; ++h) {
            const int n = n0 + h * 64 + tx * 4;
            float* dst = C + (long long)m * N + n;
            if (vec_c && n + 4 <= N) {
                *reinterpret_cast<float4*>(dst) = make_float4(
                    acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                    acc[i][h * 4 + 3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (n + j < N) dst[j] = acc[i][h * 4 + j];
            }
        }
    }
}

}  // namespace

// C[M,N] = A[M,K] @ B[K,N], f32, row-major and contiguous, with a
// (16 tm)^2 tile, tm 4 or 8. Returns the launch's cudaError_t.
extern "C" int fma_f32_first(const float* a, const float* b, float* c, int M,
                             int N, int K, int tm, void* stream) {
    const int t = 16 * tm;
    const dim3 grid((N + t - 1) / t, (M + t - 1) / t);
    const int vec_a = ((uintptr_t)a & 15u) == 0 && K % 4 == 0;
    const int vec_b = ((uintptr_t)b & 15u) == 0 && N % 4 == 0;
    const int vec_c = ((uintptr_t)c & 15u) == 0 && N % 4 == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (tm == 8)
        fma_f32_first_kernel<8><<<grid, THREADS, 0, st>>>(a, b, c, M, N, K,
                                                          vec_a, vec_b, vec_c);
    else if (tm == 4)
        fma_f32_first_kernel<4><<<grid, THREADS, 0, st>>>(a, b, c, M, N, K,
                                                          vec_a, vec_b, vec_c);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
