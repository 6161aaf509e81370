// Dot-product-accumulate matmul for Hopper (sm_90a), first design: right
// and simple. C[M,N] = A[M,K] @ B[K,N], both row-major, in three variants:
//   fma_f32  f32 x f32 -> f32     FFMA on the CUDA cores (never TF32)
//   dpa2     bf16 x bf16 -> f32   mma.sync m16n8k16, f32 accumulator
//   dpa4     int8 x int8 -> int32 mma.sync m16n8k32, s32 accumulator (exact)
//
// Replaces repro/kernels/dpa_matmul/dpa_matmul.py:42 dpa_matmul (body
// _matmul_kernel :25), the Pallas TPU kernel: a (M/bm, N/bn, K/bk) grid
// whose K axis runs in order on the one core and carries the accumulator
// in VMEM scratch. Hopper's blocks run in no order, so here each block owns
// one 128x128 output tile and runs the whole K loop itself; K is never
// split across blocks. The TPU's 128x128x256 tiling does not carry over.
//
// What bounds it. At the slice's sizes (the bench's 512^3, and 4096^3) the
// work is 2*M*N*K operations against (M*K + K*N)*in + M*N*out bytes. At
// 4096^3 every variant is bound by operations: 2.05 ms at 67 TFLOP/s for
// f32, 0.139 ms at 989 TFLOP/s for bf16 and 0.069 ms at 1979 TOP/s for
// int8 (H100 SXM data sheet). At 512^3 f32 is still bound by operations
// (4.0 us) and bf16/int8 by bytes (0.63 / 0.47 us), where 16 blocks
// cannot fill 132 SMs and a launch costs more than the bound anyway.
// This design reaches for the operations with register tiles: an 8x8 FFMA
// tile per thread for f32, and per warp a 64x32 tile of mma.sync
// fragments for bf16/int8, fed from shared memory that holds one 64-byte
// K slice of A and of B (B transposed on its way in, so each fragment
// register is one 32-bit load; rows padded to 80 bytes, which makes the
// fragment loads free of bank conflicts). The next tile is fetched into
// registers while the current one is multiplied. What it leaves for later
// designs: wgmma (the only way to the full tensor-core rate), TMA with an
// mbarrier ring of several stages, and persistent blocks.
//
// Edges: rows, columns and K beyond the matrix are loaded as zeros and
// outputs beyond it are not stored, so any M, N, K is right; 16-byte loads
// are used when a row's byte stride and the base pointers allow them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;
constexpr int THREADS = 256;

// 16 bytes of a row starting at element `col`, zeros beyond `ncols` or when
// the row is outside the matrix
template <typename E>
__device__ __forceinline__ uint4 load_chunk(const E* __restrict__ base,
                                            long long row, long long ld,
                                            bool row_ok, int col, int ncols,
                                            bool vec) {
    constexpr int V = 16 / sizeof(E);
    uint4 r = make_uint4(0, 0, 0, 0);
    if (!row_ok || col >= ncols) return r;
    const E* p = base + row * ld + col;
    if (vec && col + V <= ncols) return *reinterpret_cast<const uint4*>(p);
    E* out = reinterpret_cast<E*>(&r);
#pragma unroll
    for (int j = 0; j < V; ++j)
        if (col + j < ncols) out[j] = p[j];
    return r;
}

// ---------------------------------------------------------------------------
// fma_f32: 128x128 block tile, K slices of 8, 8x8 outputs per thread

constexpr int F_BK = 8;

__global__ void __launch_bounds__(THREADS)
fma_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int N, int K, int vec_a,
               int vec_b, int vec_c) {
    __shared__ __align__(16) float As[F_BK][BM];    // A transposed: k-major
    __shared__ __align__(16) float Bs[F_BK][BN];
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int a_row = tid / 2, a_col = (tid % 2) * 4;    // 128 rows x 8 k
    const int b_row = tid / 32, b_col = (tid % 32) * 4;  // 8 k x 128 cols
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    auto fetch = [&](int k0, uint4& ra, uint4& rb) {
        ra = load_chunk<float>(A, m0 + a_row, K, m0 + a_row < M, k0 + a_col,
                               K, vec_a);
        rb = load_chunk<float>(B, k0 + b_row, N, k0 + b_row < K, n0 + b_col,
                               N, vec_b);
    };
    uint4 ra, rb;
    fetch(0, ra, rb);
    for (int k0 = 0; k0 < K; k0 += F_BK) {
        const float* av = reinterpret_cast<const float*>(&ra);
#pragma unroll
        for (int j = 0; j < 4; ++j) As[a_col + j][a_row] = av[j];
        *reinterpret_cast<uint4*>(&Bs[b_row][b_col]) = rb;
        __syncthreads();
        if (k0 + F_BK < K) fetch(k0 + F_BK, ra, rb);
#pragma unroll
        for (int kk = 0; kk < F_BK; ++kk) {
            float ar[8], br[8];
            *reinterpret_cast<float4*>(&ar[0]) =
                *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            *reinterpret_cast<float4*>(&ar[4]) =
                *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
            *reinterpret_cast<float4*>(&br[0]) =
                *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            *reinterpret_cast<float4*>(&br[4]) =
                *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        if (m >= M) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
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

// ---------------------------------------------------------------------------
// dpa2 / dpa4: 8 warps as 2 (M) x 4 (N), each a 64x32 tile of 4x4 mma
// fragments; shared memory holds a 64-byte K slice per row (32 bf16 or
// 64 int8), i.e. two mma K-steps of 32 bytes each

constexpr int SLICE = 64;                  // bytes of K per tile row
constexpr int ROW = SLICE + 16;            // padded row: 80 bytes, 20 words

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename E, typename Acc>
__global__ void __launch_bounds__(THREADS)
mma_kernel(const E* __restrict__ A, const E* __restrict__ B,
           Acc* __restrict__ C, int M, int N, int K, int vec_a, int vec_b) {
    constexpr int V = 16 / sizeof(E);                   // elements per chunk
    constexpr int BK = SLICE / sizeof(E);               // K per tile
    constexpr int B_CPR = BN * sizeof(E) / 16;          // B chunks per k row
    __shared__ __align__(16) uint8_t As[BM * ROW];
    __shared__ __align__(16) uint8_t Bs[BN * ROW];      // B transposed
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    Acc acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

    // each thread moves two 16-byte chunks of A (128 rows x 4 chunks) and
    // two of B (BK rows x B_CPR chunks) per tile
    uint4 ra[2], rb[2];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
            const int c = tid + c2 * THREADS;
            const int ar = c / 4, ac = (c % 4) * V;
            ra[c2] = load_chunk<E>(A, m0 + ar, K, m0 + ar < M, k0 + ac, K,
                                   vec_a);
            const int br = c / B_CPR, bc = (c % B_CPR) * V;
            rb[c2] = load_chunk<E>(B, k0 + br, N, k0 + br < K, n0 + bc, N,
                                   vec_b);
        }
    };
    auto stash = [&]() {
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
            const int c = tid + c2 * THREADS;
            const int ar = c / 4, ac = (c % 4) * 16;
            *reinterpret_cast<uint4*>(&As[ar * ROW + ac]) = ra[c2];
            const int br = c / B_CPR, bc = (c % B_CPR) * V;
            const E* p = reinterpret_cast<const E*>(&rb[c2]);
#pragma unroll
            for (int j = 0; j < V; ++j)
                *reinterpret_cast<E*>(&Bs[(bc + j) * ROW + br * sizeof(E)]) =
                    p[j];
        }
    };

    fetch(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
        stash();
        __syncthreads();
        if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll
        for (int ks = 0; ks < SLICE; ks += 32) {
            uint32_t af[4][4], bf[4][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const uint8_t* p = &As[(wm + i * 16 + g) * ROW + ks + t * 4];
                af[i][0] = *reinterpret_cast<const uint32_t*>(p);
                af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW);
                af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
                af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW + 16);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint8_t* p = &Bs[(wn + j * 8 + g) * ROW + ks + t * 4];
                bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
                bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bf[j]);
        }
        __syncthreads();
    }
    // accumulator fragment: c0,c1 at (g, 2t..2t+1), c2,c3 at (g+8, 2t..2t+1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + wm + i * 16 + g + h * 8;
                const int n = n0 + wn + j * 8 + t * 2;
                if (m >= M) continue;
                Acc* dst = C + (long long)m * N + n;
                if (n < N) dst[0] = acc[i][j][h * 2];
                if (n + 1 < N) dst[1] = acc[i][j][h * 2 + 1];
            }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// variant: 0 = fma_f32 (f32 in, f32 out), 1 = dpa2 (bf16 in, f32 out),
// 2 = dpa4 (int8 in, int32 out). A [M,K], B [K,N], C [M,N], row-major and
// contiguous. Returns the cudaError_t of the launch (0 on success).
extern "C" int dpa_matmul(const void* a, const void* b, void* c, int M, int N,
                          int K, int variant, void* stream) {
    if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const int in_size = variant == 0 ? 4 : variant == 1 ? 2 : 1;
    const int vec_a = aligned16(a) && ((long long)K * in_size) % 16 == 0;
    const int vec_b = aligned16(b) && ((long long)N * in_size) % 16 == 0;
    if (variant == 0) {
        const int vec_c = aligned16(c) && N % 4 == 0;
        fma_f32_kernel<<<grid, THREADS, 0, st>>>(
            static_cast<const float*>(a), static_cast<const float*>(b),
            static_cast<float*>(c), M, N, K, vec_a, vec_b, vec_c);
    } else if (variant == 1) {
        mma_kernel<__nv_bfloat16, float><<<grid, THREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(a),
            static_cast<const __nv_bfloat16*>(b), static_cast<float*>(c), M,
            N, K, vec_a, vec_b);
    } else if (variant == 2) {
        mma_kernel<int8_t, int><<<grid, THREADS, 0, st>>>(
            static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
            static_cast<int*>(c), M, N, K, vec_a, vec_b);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
