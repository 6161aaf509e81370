// Dot-product-accumulate matmul for Hopper (sm_90a). C[M,N] = A[M,K] @
// B[K,N], both row-major, in three variants on three routes:
//   fma_f32  f32 x f32 -> f32     FFMA tiles on the CUDA cores (never TF32)
//   dpa2     bf16 x bf16 -> f32   wgmma fed by a TMA ring; mma.sync where
//                                 TMA cannot describe A or B
//   dpa4     int8 x int8 -> int32 mma.sync m16n8k32, s32 accumulator (exact)
//
// Replaces src/repro/kernels/dpa_matmul/dpa_matmul.py:42 dpa_matmul
// (pl.pallas_call at :66, body _matmul_kernel :25): a (M/bm, N/bn, K/bk)
// grid whose K axis runs in order on the one core and carries the
// accumulator in VMEM scratch. Hopper's blocks run in no order, so here
// each block owns one output tile and runs the whole K loop itself; K is
// never split across blocks and no sum is taken with atomics, so a result
// does not change from call to call. The TPU's 128x128x256 tiling does not
// carry over: the tile is chosen per call by the wrapper's plan() (the
// largest tile whose grid fills the card's SMs, else the smallest) and
// passed in here.
//
// What bounds each variant on an H100 SXM (data sheet, dense): at 4096^3
// all three are bound by operations, 2.05 ms at 67 TFLOP/s for f32, 0.139
// ms at 989 TFLOP/s for bf16, 0.069 ms at 1979 TOP/s for int8. At 512^3
// f32 is still bound by operations (4.0 us) and bf16/int8 by bytes (0.63 /
// 0.47 us); there a 128x128 tile gives 16 blocks for 132 SMs, so the grid,
// not the loop, sets the time.
//
// What the designs do about it.
// - dpa2, wgmma route (dpa2_wgmma_kernel): only wgmma reaches the tensor
//   cores' full rate. One producer thread issues TMA loads
//   (cp.async.bulk.tensor) of 64-deep K stages of A and B into a ring of
//   four stages in shared memory, with mbarrier expect-tx completion; one
//   or two consumer warpgroups (64 rows each) run wgmma m64nBNk16 on each
//   stage that has arrived and release it through a second mbarrier while
//   the next group of wgmma runs. A is K-major: 128-byte rows, 128-byte
//   swizzle. B is [K,N] row-major, so MN-major: TMA boxes of 64 k x 64 n
//   (128-byte rows, 128-byte swizzle) that wgmma reads through its
//   transpose-B flag, with no transpose pass. The accumulator stays in
//   registers and the epilogue stores f32 from its layout, masking rows
//   and columns past M and N; TMA fills the box past the matrix with
//   zeros. TMA needs 16-byte row strides (K % 8 == 0 and N % 8 == 0) and
//   16-byte-aligned bases: other shapes take the mma.sync route, chosen by
//   shape before the launch. cuTensorMapEncodeTiled is a driver function:
//   it is fetched through cudaGetDriverEntryPoint, so the library links no
//   libcuda.
// - fma_f32 (fma_f32_kernel): 32-deep K slices through a ring of shared
//   stages (four at the 128x128 tile, three at the 64x64 tile that gives
//   64 blocks at 512^3) that cp.async fills ahead of the slice being
//   multiplied: one barrier per 2048 FFMA a thread at the 128 tile (8x8
//   outputs a thread), where the first design had two per 512. cp.async's
//   src-size zero-fills past the matrix, so any M, N, K is right; rows that
//   are not 16 bytes aligned go by 4-byte copies. A stays K-major, its
//   16-byte chunks XOR-swizzled by row, and a warp is 4 threads down by 8
//   across, so neither the copies into shared memory nor the fragment
//   loads meet a bank conflict (the first design transposed A by scalar
//   stores with a two-way conflict).
// - dpa4, and dpa2 where TMA cannot describe it (mma_kernel): a 128x128
//   tile of mma.sync fragments, 8 warps of 64x32, fed from shared memory
//   holding one 64-byte K slice of A and of B (B transposed on its way in,
//   rows padded to 80 bytes); the next slice is fetched into registers
//   while the current one is multiplied. Its loop time is set per slice
//   by those loads, stores and barriers, not by the tensor cores, so dpa2
//   there (32 bf16 a slice) takes twice dpa4's time (64 int8 a slice).
//
// What it leaves for later designs: persistent blocks (one epilogue
// overlapping the next tile's loads), clusters with TMA multicast of the
// shared A or B tile, and dpa4 on wgmma s8, which takes B only K-major and
// so needs the transpose that bf16 does not.
#include <cuda_bf16.h>

#include "sm90.cuh"            // smem addresses, mbarriers, TMA, wgmma fences

namespace {

using namespace sm90;

constexpr int BM = 128, BN = 128;          // mma_kernel's tile
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
// fma_f32: 16 x 16 threads, each TM x TM outputs, so a (16 TM)^2 block
// tile; K in slices of F_BK through a ring of fma_stages<TM>() shared
// stages that cp.async fills while earlier slices are multiplied.

constexpr int F_BK = 32;

// four stages and one block an SM at the 128 tile, three stages and two
// blocks at the 64 tile: of the slice depths, stage counts and fragment
// widths tried on the H100, the fastest at each tile
// (benchmarks/fma_f32_designs.py times it beside the first design)
template <int TM>
__host__ __device__ constexpr int fma_stages() { return TM == 8 ? 4 : 3; }

template <int TM>
__host__ __device__ constexpr int fma_smem() {
    return fma_stages<TM>() * 2 * 16 * TM * F_BK * 4;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes of a row from element `col` into shared `dst`, zeros past
// `ncols` or where the row is outside the matrix (cp.async's src-size
// zero-fills the rest); 4-byte copies where rows are not 16-byte aligned
template <bool VEC>
__device__ __forceinline__ void fetch_chunk(uint32_t dst,
                                            const float* __restrict__ base,
                                            long long row, long long ld,
                                            bool row_ok, int col, int ncols) {
    const int n = row_ok ? max(0, min(4, ncols - col)) : 0;
    const float* p = n > 0 ? base + row * ld + col : base;
    if (VEC) {
        cp_async16(dst, p, 4 * n);
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            cp_async4(dst + 4 * j, j < n ? p + j : base, j < n ? 4 : 0);
    }
}

// A is held K-major, one 128-byte row of F_BK floats per tile row, its
// eight 16-byte chunks XOR-swizzled by the row's low two bits. A warp is 4
// threads down by 8 across and a thread's rows are ty + 16 i, so a
// fragment load (8 bytes of one chunk) reads 2 consecutive rows in each
// half-warp, and a copy writes one whole row in each quarter-warp: both
// land in distinct banks. B is [F_BK][16 TM], row-major: a fragment load
// reads 128 contiguous bytes.
__device__ __forceinline__ int a_swizzle(int row) { return row & 3; }

// VEC: the rows of A and B are 16-byte aligned (chosen at compile time:
// a run-time choice read slower at 4096^3)
template <int TM, bool VEC>
__global__ void __launch_bounds__(THREADS, TM == 8 ? 1 : 2)
fma_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int M, int N, int K, int vec_c) {
    constexpr int T = 16 * TM, S = fma_stages<TM>();
    constexpr int CPR = F_BK / 4;                    // chunks in a row of A
    constexpr int CHUNKS = T * F_BK / 4 / THREADS;   // 16-byte copies a
                                                     // thread, of A and of B
    extern __shared__ __align__(16) float fsm[];
    float (*As)[T][F_BK] = reinterpret_cast<float (*)[T][F_BK]>(fsm);
    float (*Bs)[F_BK][T] =
        reinterpret_cast<float (*)[F_BK][T]>(fsm + S * T * F_BK);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
    const int m0 = blockIdx.y * T, n0 = blockIdx.x * T;
    const int nk = (K + F_BK - 1) / F_BK;

    auto fetch = [&](int kb) {
        const int s = kb % S, k0 = kb * F_BK;
#pragma unroll
        for (int c2 = 0; c2 < CHUNKS; ++c2) {
            const int c = tid + c2 * THREADS;
            const int ar = c / CPR, ac = c % CPR;
            fetch_chunk<VEC>(smem_u32(&As[s][ar][(ac ^ a_swizzle(ar)) * 4]),
                             A, m0 + ar, K, m0 + ar < M, k0 + ac * 4, K);
            const int br = c / (T / 4), bc = (c % (T / 4)) * 4;
            fetch_chunk<VEC>(smem_u32(&Bs[s][br][bc]), B, k0 + br, N,
                             k0 + br < K, n0 + bc, N);
        }
    };

    float acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

    // one commit group per slice (empty past the end), so that waiting
    // for all but the newest S - 2 groups finds slice kb arrived
#pragma unroll
    for (int kb = 0; kb < S - 1; ++kb) {
        if (kb < nk) fetch(kb);
        cp_async_commit();
    }
    const int sw = a_swizzle(ty);          // that of every row ty + 16 i
    for (int kb = 0; kb < nk; ++kb) {
        cp_async_wait<S - 2>();
        // slice kb is in for every thread, and the stage the next fetch
        // overwrites was last read in the previous iteration
        __syncthreads();
        if (kb + S - 1 < nk) fetch(kb + S - 1);
        cp_async_commit();
        const int s = kb % S;
#pragma unroll
        for (int kp = 0; kp < F_BK; kp += 2) {        // two k at a time
            float a[TM][2];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                *reinterpret_cast<float2*>(a[i]) =
                    *reinterpret_cast<const float2*>(
                        &As[s][ty + 16 * i][((kp / 4) ^ sw) * 4 + kp % 4]);
#pragma unroll
            for (int kq = 0; kq < 2; ++kq) {
                float b[TM];
#pragma unroll
                for (int h = 0; h < TM / 4; ++h)
                    *reinterpret_cast<float4*>(&b[h * 4]) =
                        *reinterpret_cast<const float4*>(
                            &Bs[s][kp + kq][h * 64 + tx * 4]);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TM; ++j)
                        acc[i][j] = fmaf(a[i][kq], b[j], acc[i][j]);
            }
        }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty + 16 * i;
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

// ---------------------------------------------------------------------------
// dpa2 on wgmma: W_STAGES stages of W_BK = 64 bf16 (128-byte rows), each
// holding A [BM rows][64 k] (one TMA box) and B as BN/64 boxes of
// [64 k][64 n]; NWG consumer warpgroups of 64 rows, then a producer
// warpgroup of which one thread issues the TMA loads

constexpr int W_BK = 64;
constexpr int W_STAGES = 4;

template <int NWG, int TBN>
__host__ __device__ constexpr int wgmma_stage() {
    return 64 * NWG * 128 + TBN * 128;
}

// the ring, its 2 x W_STAGES mbarriers, and 1 KB to align the ring to the
// 1024-byte period of the 128-byte swizzle
template <int NWG, int TBN>
__host__ __device__ constexpr int wgmma_smem() {
    return W_STAGES * wgmma_stage<NWG, TBN>() + 16 * W_STAGES + 1024;
}

// wgmma m64nNk16, f32 += bf16 x bf16, A and B from shared memory; A
// K-major (trans-a 0), B MN-major (trans-b 1). d holds N/2 f32 a thread.
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da,
                                      uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da,
                                      uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
        "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

template <int NWG, int TBN>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
dpa2_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  float* __restrict__ C, int M, int N, int K) {
    constexpr int A_BYTES = 64 * NWG * 128;
    constexpr int STAGE = wgmma_stage<NWG, TBN>();
    extern __shared__ __align__(16) uint8_t wsm[];
    const uint32_t ring = (smem_u32(wsm) + 1023) & ~1023u;
    const uint32_t full = ring + W_STAGES * STAGE;      // TMA -> consumers
    const uint32_t empty = full + 8 * W_STAGES;         // consumers -> TMA
    const int wg = threadIdx.x / 128;
    const int nk = (K + W_BK - 1) / W_BK;
    const int m0 = blockIdx.y * 64 * NWG, n0 = blockIdx.x * TBN;
    if (threadIdx.x == 0) {
#pragma unroll
        for (int s = 0; s < W_STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, NWG * 128);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == NWG) {                                    // producer
        if (threadIdx.x == NWG * 128) {
            for (int kb = 0; kb < nk; ++kb) {
                const int s = kb % W_STAGES;
                // a fresh barrier passes parity 1 at once: the first round
                // finds every stage free
                mbar_wait(empty + 8 * s, ((kb / W_STAGES) & 1) ^ 1);
                const uint32_t st = ring + s * STAGE, bar = full + 8 * s;
                mbar_expect_tx(bar, STAGE);
                tma_load(st, &tma_a, kb * W_BK, m0, bar);
#pragma unroll
                for (int j = 0; j < TBN / 64; ++j)
                    tma_load(st + A_BYTES + j * 8192, &tma_b, n0 + j * 64,
                             kb * W_BK, bar);
            }
        }
        return;
    }

    float acc[TBN / 2];
#pragma unroll
    for (int i = 0; i < TBN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % W_STAGES;
        mbar_wait(full + 8 * s, (kb / W_STAGES) & 1);
        const uint32_t sa = ring + s * STAGE + wg * 64 * 128;
        const uint32_t sb = ring + s * STAGE + A_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W_BK / 16; ++kk)     // A: +32 bytes along K;
            wgmma(acc, wgmma_desc(sa + kk * 32, 16, 1024),    // B: +16 rows
                  wgmma_desc(sb + kk * 16 * 128, 8192, 1024));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();                   // stage kb-1 is read: release it
        if (kb > 0) mbar_arrive(empty + 8 * ((kb - 1) % W_STAGES));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // accumulator layout: acc[4i..4i+3] at rows (r, r, r+8, r+8), columns
    // (c, c+1, c, c+1) + 8i, r = 16 * warp + lane / 4, c = 2 * (lane % 4);
    // N % 8 == 0, so c < N gives c + 1 < N
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int r = m0 + wg * 64 + warp * 16 + lane / 4;
    const int c = n0 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < TBN / 8; ++i) {
        const int n = c + i * 8;
        if (n >= N) continue;
        if (r < M)
            *reinterpret_cast<float2*>(C + (long long)r * N + n) =
                make_float2(acc[4 * i], acc[4 * i + 1]);
        if (r + 8 < M)
            *reinterpret_cast<float2*>(C + (long long)(r + 8) * N + n) =
                make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
}

// a row-major bf16 [rows, cols] matrix in boxes of box_rows x 64 columns
// (128 bytes), 128-byte swizzle, zeros past the matrix
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    return encode_bf16(map, base, 2, dims, box_rows);
}

// routes: 0 = FFMA tiles, 1 = mma.sync, 2 = wgmma fed by TMA
struct Kernel {
    const void* fn;
    int threads, smem;
};

// the kernel of (variant, route, tile), or fn == nullptr where that
// combination does not exist; vec: the FFMA kernel for 16-byte-aligned rows
Kernel kernel_of(int variant, int route, int bm, int bn, bool vec) {
    const auto tile = [&](int m, int n) { return bm == m && bn == n; };
    if (variant == 0 && route == 0) {
        if (tile(128, 128))
            return {vec ? (const void*)fma_f32_kernel<8, true>
                        : (const void*)fma_f32_kernel<8, false>,
                    THREADS, fma_smem<8>()};
        if (tile(64, 64))
            return {vec ? (const void*)fma_f32_kernel<4, true>
                        : (const void*)fma_f32_kernel<4, false>,
                    THREADS, fma_smem<4>()};
    }
    if (route == 1 && tile(BM, BN)) {
        if (variant == 1)
            return {(const void*)mma_kernel<__nv_bfloat16, float>, THREADS, 0};
        if (variant == 2)
            return {(const void*)mma_kernel<int8_t, int>, THREADS, 0};
    }
    if (variant == 1 && route == 2) {
        if (tile(128, 256))
            return {(const void*)dpa2_wgmma_kernel<2, 256>, 384,
                    wgmma_smem<2, 256>()};
        if (tile(64, 64))
            return {(const void*)dpa2_wgmma_kernel<1, 64>, 256,
                    wgmma_smem<1, 64>()};
    }
    return {nullptr, 0, 0};
}

}  // namespace

// variant: 0 = fma_f32 (f32 in, f32 out), 1 = dpa2 (bf16 in, f32 out),
// 2 = dpa4 (int8 in, int32 out); route and tile (bm x bn) as the wrapper's
// plan() chose them. A [M,K], B [K,N], C [M,N], row-major and contiguous.
// Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a shape or plan no kernel takes.
extern "C" int dpa_matmul(const void* a, const void* b, void* c, int M, int N,
                          int K, int variant, int route, int bm, int bn,
                          void* stream) {
    const int in_size = variant == 0 ? 4 : variant == 1 ? 2 : 1;
    int vec_a = aligned16(a) && ((long long)K * in_size) % 16 == 0;
    int vec_b = aligned16(b) && ((long long)N * in_size) % 16 == 0;
    int vec_c = aligned16(c) && N % 4 == 0;     // fma_f32 only
    const Kernel k = kernel_of(variant, route, bm, bn, vec_a && vec_b);
    if (k.fn == nullptr || M <= 0 || N <= 0 || K <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
    if (k.smem > 0) {
        const cudaError_t e = cudaFuncSetAttribute(
            k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
        if (e != cudaSuccess) return (int)e;
    }
    cudaError_t e;
    if (route == 2) {
        // TMA: 16-byte-aligned bases and row strides
        if (!vec_a || !vec_b) return (int)cudaErrorInvalidValue;
        CUtensorMap ta, tb;
        if (!encode(&ta, a, M, K, bm) || !encode(&tb, b, K, N, 64))
            return (int)cudaErrorInvalidValue;
        void* args[] = {&ta, &tb, &c, &M, &N, &K};
        e = cudaLaunchKernel(k.fn, grid, k.threads, args, k.smem, st);
    } else if (route == 0) {
        void* args[] = {&a, &b, &c, &M, &N, &K, &vec_c};
        e = cudaLaunchKernel(k.fn, grid, k.threads, args, k.smem, st);
    } else {
        void* args[] = {&a, &b, &c, &M, &N, &K, &vec_a, &vec_b};
        e = cudaLaunchKernel(k.fn, grid, k.threads, args, k.smem, st);
    }
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// what the compiler gave the kernel of (variant, route, tile), the FFMA
// one for 16-byte-aligned rows: out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] static
// shared bytes, out[3] dynamic shared bytes a launch asks, out[4] threads
// a block. Returns a cudaError_t.
extern "C" int dpa_matmul_attributes(int variant, int route, int bm, int bn,
                                     int* out) {
    const Kernel k = kernel_of(variant, route, bm, bn, true);
    if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, k.fn);
    if (e != cudaSuccess) return (int)e;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = (int)attr.sharedSizeBytes;
    out[3] = k.smem;
    out[4] = k.threads;
    return 0;
}
