// Flash attention forward for Hopper (sm_90a), on two routes.
//
// Replaces repro/kernels/flash_attention/flash_attention.py::_flash_kernel,
// the Pallas TPU kernel: one-pass online-softmax attention with an f32
// running max, denominator and accumulator, causal and sliding-window masks,
// output in q's dtype. On top of that it takes what serving needs:
//   * ragged S and T (bounds masks instead of the TPU kernel's
//     divisibility assert);
//   * q_offset: query row i sits at position q_offset + i, key j at j
//     (chunked prefill after a prefix-cache hit);
//   * GQA by head index: k/v are [B, Hkv, T, D], query head h reads kv head
//     h / (H / Hkv), so granite's 48:1 cache is never repeated;
//   * KV tiles past the causal edge (or before the window) are skipped.
// The route and the tile come from the wrapper's plan() (kernels/
// flash_attention/ops.py), chosen from the shape before the launch; the
// entry point refuses a plan its kernels cannot run.
//
// What bounds it. At the serve's prefill shapes (granite-20b: H=48, Hkv=1,
// D=128, S a bucket of up to 256 rows, T=512) q and o (S*H*D each) dominate
// the bytes, since the 48:1 cache is one head; each query row does 4*D
// operations per visible key against 4*D bytes of q and o, so the intensity
// is the number of visible keys per row (~130 for a cold 256-row prefill),
// below the card's ~295 operations per byte: the bound is bytes, near the
// ridge, and a few microseconds.
//
// Route "ffma" (flash_fwd_kernel; f32, and bf16 with D 16 or 32), the first
// design: the arithmetic in f32 FMA on the CUDA cores (true f32 for f32
// inputs, no TF32) over a grid of B*H*ceil(S/64) blocks. One block of 256
// threads per (batch*head, 64-row query tile). Four consecutive lanes share
// a query row; each owns D/4 of its dims in float4 chunks interleaved so
// the four lanes read one contiguous 64-byte span of a shared-memory key
// row (no bank conflicts). Scores are reduced across the four lanes with
// two xor-shuffles. KV tiles of 32 keys are staged through shared memory
// as f32. Registers hold q, the accumulator, the tile's 32 scores and the
// online-softmax state.
//
// Route "wgmma" (flash_fwd_wgmma_kernel; bf16 with D 64 or 128), the
// tensor-core design:
//   * GQA packing along M. q [B,H,S,D] is contiguous, so the g = H/Hkv
//     query heads that read kv head hk are g*S consecutive rows of one
//     [g*S, D] matrix; packed row r sits at position q_offset + r % S. A
//     block takes 64 packed rows of one (batch, kv head), so one stream of
//     K/V tiles serves all of granite's 48 heads (the ffma route stages the
//     same K/V once per head). A tile may cross a head boundary: its causal
//     key range ends at the largest position among its rows, its window
//     starts at the smallest, and each element is masked by its own row's
//     position. (A 128-row tile on two warpgroups was slower or level at
//     every serve shape, so it is not kept.)
//   * Data movement: one producer warp issues TMA loads of 3-D boxes
//     ([B*Hkv][rows][D]; rows past g*S or T read as zeros) with 128-byte
//     swizzle, a D=128 row as two 64-wide boxes: the Q tile once, then K
//     and V tiles of 64 keys through a ring of W_STAGES stages: a full
//     mbarrier for each K and each V tile, so that S = Q K^T starts before
//     V lands, and an empty one a stage that the consumers release it on.
//   * Products on one consumer warpgroup of 64 rows: S = Q K^T as wgmma
//     m64n64k16 with both operands K-major in shared memory; O += P V as
//     wgmma m64nDk16 with P from registers (the f32 accumulator fragment of
//     S is the bf16 A fragment thread for thread, as FlashAttention-3 uses)
//     and V MN-major through the transpose-B flag, as dpa2 reads B.
//   * Softmax in registers on the accumulator fragment: row max and sum
//     as trees over a thread's 16 values, then over the four threads that
//     share a row; 2^x on the special-function unit (ex2.approx) with
//     scale*log2(e) folded into one FMA; the running max, the denominator
//     and O stay in f32. Masks only on tiles that the causal, window or T
//     edge cuts, and a block visits its key tiles from the last down, so
//     that the cut tile comes first.
//   * Order: under a causal mask the blocks launched first take the tiles
//     at the end of each head, which see the most keys, so that no SM ends
//     up with two of them while others idle.
//   * Epilogue: O scaled by 1/max(l, 1e-30), rounded to bf16 into the Q
//     tile's own (swizzled) shared memory, and stored by TMA, whose tensor
//     bounds drop the rows past g*S.
//   Numerics: P is rounded to bf16 before P V (a relative error of at most
//   2^-9 a weight) where the reference keeps P and V in f32; the row sum l
//   is taken from the unrounded f32 P. The bf16 tolerance (2e-2) covers it.
//   Left for later designs: overlapping one tile's softmax with the next
//   tile's Q K^T, ping-pong warpgroups, persistent blocks, clusters, fp8.
#include <cuda_bf16.h>

#include "sm90.cuh"            // smem addresses, mbarriers, TMA, wgmma fences

namespace {

constexpr int BLOCK_M = 64;            // query rows per block
constexpr int BLOCK_N = 32;            // keys per shared-memory tile
constexpr int LANES_PER_ROW = 4;
constexpr int THREADS = BLOCK_M * LANES_PER_ROW;
constexpr float NEG_INF = -1e30f;      // the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int Hkv, int S, int Tk, int q_offset, int causal,
                 int window, float scale) {
    constexpr int CHUNKS = D / 16;     // float4 chunks per lane
    __shared__ __align__(16) float ks[BLOCK_N][D];
    __shared__ __align__(16) float vs[BLOCK_N][D];

    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh % H;
    const int hk = h / (H / Hkv);
    const int tid = threadIdx.x;
    const int r = tid / LANES_PER_ROW;             // row in the tile
    const int lane = tid % LANES_PER_ROW;
    const int row0 = blockIdx.y * BLOCK_M;
    const int row = row0 + r;
    const bool row_ok = row < S;
    const int qpos = q_offset + row;

    const T* qh = q + ((size_t)bh * S) * D;
    const T* kh = k + ((size_t)(b * Hkv + hk) * Tk) * D;
    const T* vh = v + ((size_t)(b * Hkv + hk) * Tk) * D;

    // this lane's dims: d = 16*c + 4*lane + e
    float qr[CHUNKS][4];
    float acc[CHUNKS][4];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int d = 16 * c + 4 * lane + e;
            qr[c][e] = row_ok ? to_f32(qh[(size_t)row * D + d]) : 0.f;
            acc[c][e] = 0.f;
        }
    float m_run = NEG_INF;
    float l_run = 0.f;

    // keys this tile of queries can see: [lo, hi)
    const int last_q = q_offset + min(row0 + BLOCK_M, S) - 1;
    int hi = causal ? min(Tk, last_q + 1) : Tk;
    int lo = 0;
    if (window > 0) lo = max(0, q_offset + row0 - window + 1);
    lo = (lo / BLOCK_N) * BLOCK_N;

    for (int n0 = lo; n0 < hi; n0 += BLOCK_N) {
        __syncthreads();                           // previous tile consumed
        for (int e = tid; e < BLOCK_N * D; e += THREADS) {
            const int j = e / D, d = e % D;
            const int kj = n0 + j;
            const bool ok = kj < Tk;
            ks[j][d] = ok ? to_f32(kh[(size_t)kj * D + d]) : 0.f;
            vs[j][d] = ok ? to_f32(vh[(size_t)kj * D + d]) : 0.f;
        }
        __syncthreads();

        float s[BLOCK_N];
        unsigned valid = 0u;
        float tile_max = NEG_INF;
#pragma unroll
        for (int j = 0; j < BLOCK_N; ++j) {
            float part = 0.f;
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
                const float4 kv4 =
                    *reinterpret_cast<const float4*>(&ks[j][16 * c + 4 * lane]);
                part = fmaf(qr[c][0], kv4.x, part);
                part = fmaf(qr[c][1], kv4.y, part);
                part = fmaf(qr[c][2], kv4.z, part);
                part = fmaf(qr[c][3], kv4.w, part);
            }
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            const int kj = n0 + j;
            bool ok = kj < Tk;
            if (causal) ok = ok && kj <= qpos;
            if (window > 0) ok = ok && (qpos - kj) < window;
            s[j] = ok ? part * scale : NEG_INF;
            if (ok) {
                valid |= 1u << j;
                tile_max = fmaxf(tile_max, s[j]);
            }
        }

        const float m_new = fmaxf(m_run, tile_max);
        const float alpha = expf(m_run - m_new);
        l_run *= alpha;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
#pragma unroll
        for (int j = 0; j < BLOCK_N; ++j) {
            const float p = (valid >> j) & 1u ? expf(s[j] - m_new) : 0.f;
            l_run += p;
#pragma unroll
            for (int c = 0; c < CHUNKS; ++c) {
                const float4 v4 =
                    *reinterpret_cast<const float4*>(&vs[j][16 * c + 4 * lane]);
                acc[c][0] = fmaf(p, v4.x, acc[c][0]);
                acc[c][1] = fmaf(p, v4.y, acc[c][1]);
                acc[c][2] = fmaf(p, v4.z, acc[c][2]);
                acc[c][3] = fmaf(p, v4.w, acc[c][3]);
            }
        }
        m_run = m_new;
    }

    if (!row_ok) return;
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    T* oh = o + ((size_t)bh * S + row) * D;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            from_f32(&oh[16 * c + 4 * lane + e], acc[c][e] * inv);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Hkv, int S, int Tk, int D,
                         int q_offset, int causal, int window,
                         cudaStream_t stream) {
    const dim3 grid(B * H, (S + BLOCK_M - 1) / BLOCK_M);
    const float scale = 1.0f / sqrtf((float)D);
    const T* qp = static_cast<const T*>(q);
    const T* kp = static_cast<const T*>(k);
    const T* vp = static_cast<const T*>(v);
    T* op = static_cast<T*>(o);
    switch (D) {
    case 16:
        flash_fwd_kernel<T, 16><<<grid, THREADS, 0, stream>>>(
            qp, kp, vp, op, H, Hkv, S, Tk, q_offset, causal, window, scale);
        break;
    case 32:
        flash_fwd_kernel<T, 32><<<grid, THREADS, 0, stream>>>(
            qp, kp, vp, op, H, Hkv, S, Tk, q_offset, causal, window, scale);
        break;
    case 64:
        flash_fwd_kernel<T, 64><<<grid, THREADS, 0, stream>>>(
            qp, kp, vp, op, H, Hkv, S, Tk, q_offset, causal, window, scale);
        break;
    case 128:
        flash_fwd_kernel<T, 128><<<grid, THREADS, 0, stream>>>(
            qp, kp, vp, op, H, Hkv, S, Tk, q_offset, causal, window, scale);
        break;
    default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route "wgmma": GQA-packed query tiles of W_BM rows, one consumer
// warpgroup, then one producer warp; K/V tiles of W_BN keys.

using namespace sm90;

constexpr int W_BM = 64;               // packed query rows per block
constexpr int W_BN = 64;               // keys per K/V tile
constexpr int W_THREADS = 128 + 32;    // a consumer warpgroup, a producer warp
constexpr int W_STAGES = 2;            // K/V stages in the ring

template <int D>
__host__ __device__ constexpr int w_tile_bytes() { return W_BN * D * 2; }

// 1 KB to align the Q tile to the 1024-byte period of the 128-byte
// swizzle, the Q tile, the ring of K and V tiles, and the mbarriers: Q
// full, then K full, V full and empty for each stage
template <int D>
__host__ __device__ constexpr int w_smem() {
    return 1024 + W_BM * D * 2 + W_STAGES * 2 * w_tile_bytes<D>()
           + 8 * (1 + 3 * W_STAGES);
}

// S (+)= Q K^T: wgmma m64n64k16, f32 += bf16 x bf16, A and B K-major in
// shared memory (trans-a 0, trans-b 0); accumulate 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V: wgmma m64nDk16 with P, the A operand, from registers (four
// bf16 pairs a thread) and V MN-major in shared memory (trans-b 1). d
// holds D/2 f32 a thread.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the compiler from reusing the registers of P while the wgmma that
// reads them runs
__device__ __forceinline__ void fence_p(uint32_t (&p)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(p[i][j]) :: "memory");
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to zero); 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

// q, o: [B*Hkv][rows = g*S][D]; k, v: [B*Hkv][Tk][D], as 3-D tensor maps
// with boxes of 64 columns by 64 rows. Block (x, y) takes one tile of
// W_BM packed rows of group y.
template <int D>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v,
                       const __grid_constant__ CUtensorMap tma_o,
                       int S, int rows, int Tk, int q_offset, int causal,
                       int window, float scale_log2) {
    constexpr int BM = W_BM;
    constexpr int BOXES = D / 64;              // 64-column boxes in a row
    constexpr int Q_BOX = BM * 128;            // bytes of one Q box
    constexpr int TILE = w_tile_bytes<D>();
    extern __shared__ __align__(16) uint8_t wsm[];
    const uint32_t sq = (smem_u32(wsm) + 1023) & ~1023u;
    const uint32_t ring = sq + BM * D * 2;     // stage s: K, then V
    const uint32_t q_full = ring + W_STAGES * 2 * TILE;
    const uint32_t k_full = q_full + 8;        // + 8 s
    const uint32_t v_full = k_full + 8 * W_STAGES;
    const uint32_t empty = v_full + 8 * W_STAGES;
    const int group = blockIdx.y;              // b * Hkv + kv head
    // the block's tile of packed rows: under a causal mask with S a
    // multiple of BM, the blocks launched first take the tiles at the end
    // of each head, which see the most keys (the hardware starts blocks in
    // about the order of their index)
    int tile = blockIdx.x;
    if (causal && window <= 0 && S % BM == 0) {
        const int per_head = S / BM, heads = rows / S;
        tile = (tile % heads) * per_head + per_head - 1 - tile / heads;
    }
    const int m0 = tile * BM;                  // first packed row

    // the keys the tile's rows can see: positions pmin..pmax (the whole
    // head where the tile crosses a head boundary), tiles from lo to hi,
    // visited from the last down, so that the tile the causal edge cuts
    // comes first and blocks of different rows start on different keys
    const int r_last = min(m0 + BM, rows) - 1;
    int pmin = q_offset, pmax = q_offset + S - 1;
    if (m0 / S == r_last / S) {
        pmin = q_offset + m0 % S;
        pmax = q_offset + r_last % S;
    }
    const int hi = causal ? min(Tk, pmax + 1) : Tk;
    const int lo = window > 0 ? max(0, pmin - window + 1) / W_BN * W_BN : 0;
    const int ntiles = hi > lo ? (hi - lo + W_BN - 1) / W_BN : 0;
    const int n_last = lo + (ntiles - 1) * W_BN;   // keys of the first visit

    // K and V of the it-th tile visited into stage it % W_STAGES
    auto load_kv = [&](int it) {
        const int s = it % W_STAGES, n0 = n_last - it * W_BN;
        const uint32_t sk = ring + s * 2 * TILE, sv = sk + TILE;
        mbar_expect_tx(k_full + 8 * s, TILE);
#pragma unroll
        for (int j = 0; j < BOXES; ++j)
            tma_load(sk + j * 8192, &tma_k, j * 64, n0, group, k_full + 8 * s);
        mbar_expect_tx(v_full + 8 * s, TILE);
#pragma unroll
        for (int j = 0; j < BOXES; ++j)
            tma_load(sv + j * 8192, &tma_v, j * 64, n0, group, v_full + 8 * s);
    };

    // the producer thread sets up the barriers and starts the Q load and
    // the first stages before the block's barrier, so they are in flight
    // while the other warps arrive
    if (threadIdx.x == 128) {
        mbar_init(q_full, 1);
#pragma unroll
        for (int s = 0; s < W_STAGES; ++s) {
            mbar_init(k_full + 8 * s, 1);
            mbar_init(v_full + 8 * s, 1);
            mbar_init(empty + 8 * s, 128);
        }
        mbar_fence_init();
        mbar_expect_tx(q_full, BM * D * 2);
#pragma unroll
        for (int j = 0; j < BOXES; ++j)
            tma_load(sq + j * Q_BOX, &tma_q, j * 64, m0, group, q_full);
        for (int it = 0; it < min(ntiles, W_STAGES); ++it) load_kv(it);
    }
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 4) {                           // producer: the later stages
        if (lane == 0)
            for (int it = W_STAGES; it < ntiles; ++it) {
                // a fresh barrier passes parity 1 at once: the first
                // round finds every stage free
                mbar_wait(empty + 8 * (it % W_STAGES),
                          ((it / W_STAGES) & 1) ^ 1);
                load_kv(it);
            }
        return;
    }

    // accumulator layout (S and O alike): d[4i..4i+3] at rows (r, r, r+8,
    // r+8), columns (c, c+1, c, c+1) + 8i, r = 16 * warp + lane / 4 in the
    // tile, c = 2 * (lane % 4)
    const int rr = warp * 16 + lane / 4;           // row in the tile
    const int c0 = 2 * (lane % 4);
    // rows r and r + 8 see keys key_lo[h] ..= key_hi[h]
    int key_lo[2], key_hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int pos = q_offset + (m0 + rr + 8 * h) % S;
        key_hi[h] = causal ? min(pos, Tk - 1) : Tk - 1;
        key_lo[h] = window > 0 ? pos - window + 1 : 0;
    }
    const float neg_inf = __int_as_float(0xff800000);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {neg_inf, neg_inf}, l_run[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < ntiles; ++it) {
        const int s = it % W_STAGES;
        const uint32_t ph = (it / W_STAGES) & 1;
        const int n0 = n_last - it * W_BN;
        const uint32_t sk = ring + s * 2 * TILE, sv = sk + TILE;

        float sc[32];
        mbar_wait(k_full + 8 * s, ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {      // 32 bytes along D a step
            const uint32_t off = (kk % 4) * 32;
            wgmma_ss(sc, wgmma_desc(sq + (kk / 4) * Q_BOX + off, 16, 1024),
                     wgmma_desc(sk + (kk / 4) * 8192 + off, 16, 1024),
                     kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sc);

        // masks, only where an edge cuts the tile: the element in column
        // 8i + e of row h holds key n0 + c0 + 8i + e
        if (n0 + W_BN > Tk || (causal && n0 + W_BN - 1 > pmin)
            || (window > 0 && pmax - n0 >= window)) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int lo_rel = key_lo[h] - n0 - c0;
                const int hi_rel = key_hi[h] - n0 - c0;
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (8 * i + e < lo_rel || 8 * i + e > hi_rel)
                            sc[4 * i + 2 * h + e] = neg_inf;
            }
        }

        // online softmax on the fragment: P = 2^(S * scale * log2(e) -
        // running max), the running max and sum in f32; maxima and sums
        // over the row's 16 values as trees
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float t[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                t[i] = fmaxf(sc[4 * i + 2 * h], sc[4 * i + 2 * h + 1]);
#pragma unroll
            for (int w = 4; w > 0; w /= 2)
#pragma unroll
                for (int i = 0; i < w; ++i) t[i] = fmaxf(t[i], t[i + w]);
            float mx = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_run[h], mx);
            // a row that has seen no key yet keeps P and alpha at 0
            const float base = m_new == neg_inf ? 0.f : m_new * scale_log2;
            alpha[h] = exp2_approx(m_run[h] * scale_log2 - base);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float& x = sc[4 * i + 2 * h + e];
                    x = exp2_approx(fmaf(x, scale_log2, -base));
                }
#pragma unroll
            for (int i = 0; i < 8; ++i)
                t[i] = sc[4 * i + 2 * h] + sc[4 * i + 2 * h + 1];
#pragma unroll
            for (int w = 4; w > 0; w /= 2)
#pragma unroll
                for (int i = 0; i < w; ++i) t[i] += t[i + w];
            l_run[h] = l_run[h] * alpha[h] + t[0];   // this thread's share
            m_run[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
            o[4 * i] *= alpha[0];
            o[4 * i + 1] *= alpha[0];
            o[4 * i + 2] *= alpha[1];
            o[4 * i + 3] *= alpha[1];
        }
        // P as the A fragment of k-step kk (keys 16 kk .. 16 kk + 15):
        // (r, c), (r+8, c), (r, c+8), (r+8, c+8), each two columns
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                pa[kk][j] =
                    pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

        mbar_wait(v_full + 8 * s, ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)         // V: + 16 key rows a step
            wgmma_rs(o, pa[kk], wgmma_desc(sv + kk * 16 * 128, 8192, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(o);
        fence_p(pa);
        mbar_arrive(empty + 8 * s);            // this stage is read
    }

    // epilogue: the row sums over the four threads of a row, O / l in bf16
    // into the Q tile (the wgmma reads of Q are done), then one TMA store a
    // 64-column box
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float l = l_run[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[h] = 1.f / fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
        const int chunk = i % 8;                   // 16-byte chunk in the row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = rr + 8 * h;
            st_shared(sq + (i / 8) * Q_BOX + row * 128
                          + ((chunk ^ (row % 8)) * 16) + 2 * c0,
                      pack_bf16(o[4 * i + 2 * h] * inv[h],
                                o[4 * i + 2 * h + 1] * inv[h]));
        }
    }
    fence_proxy_async();
    // the consumer warpgroup alone (the producer warp has returned)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (threadIdx.x == 0) {
#pragma unroll
        for (int j = 0; j < BOXES; ++j)
            tma_store(&tma_o, j * 64, m0, group, sq + j * Q_BOX);
        tma_store_drain();
    }
}

// q, o: [B*Hkv][g*S][D] and k, v: [B*Hkv][Tk][D] as 3-D tensor maps; the
// route's plan as the wrapper chose it
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Hkv, int S, int Tk, int q_offset,
                         int causal, int window, cudaStream_t stream) {
    constexpr int BM = W_BM;
    int rows = (H / Hkv) * S;
    const cuuint64_t qdims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                                 (cuuint64_t)B * Hkv};
    const cuuint64_t kdims[3] = {(cuuint64_t)D, (cuuint64_t)Tk,
                                 (cuuint64_t)B * Hkv};
    CUtensorMap tq, tk, tv, to;
    if (!encode_bf16(&tq, q, 3, qdims, BM)
        || !encode_bf16(&tk, k, 3, kdims, W_BN)
        || !encode_bf16(&tv, v, 3, kdims, W_BN)
        || !encode_bf16(&to, o, 3, qdims, 64))
        return cudaErrorInvalidValue;
    const void* fn = (const void*)flash_fwd_wgmma_kernel<D>;
    constexpr int smem = w_smem<D>();
    // the shared-memory limit is raised once per device (bit d of the
    // mask): every prefill layer launches this kernel
    static unsigned long long raised = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !(raised >> dev & 1ull)) {
        e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        if (dev < 64) raised |= 1ull << dev;
    }
    float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
    void* args[] = {&tq, &tk, &tv, &to, &S, &rows, &Tk, &q_offset, &causal,
                    &window, &scale_log2};
    const dim3 grid((rows + BM - 1) / BM, B * Hkv);
    const cudaError_t l = cudaLaunchKernel(fn, grid, W_THREADS, args, smem,
                                           stream);
    return l != cudaSuccess ? l : cudaGetLastError();
}

struct Kernel {
    const void* fn;
    int threads, smem;
};

// the kernel of (route, block_m, D, dtype), or fn == nullptr where that
// combination does not exist
Kernel kernel_of(int route, int block_m, int D, int dtype) {
    if (route == 0 && block_m == BLOCK_M && (dtype == 0 || dtype == 1)) {
        const bool f = dtype == 0;
        switch (D) {
        case 16: return {f ? (const void*)flash_fwd_kernel<float, 16>
                           : (const void*)flash_fwd_kernel<__nv_bfloat16, 16>,
                         THREADS, 0};
        case 32: return {f ? (const void*)flash_fwd_kernel<float, 32>
                           : (const void*)flash_fwd_kernel<__nv_bfloat16, 32>,
                         THREADS, 0};
        case 64: return {f ? (const void*)flash_fwd_kernel<float, 64>
                           : (const void*)flash_fwd_kernel<__nv_bfloat16, 64>,
                         THREADS, 0};
        case 128:
            return {f ? (const void*)flash_fwd_kernel<float, 128>
                      : (const void*)flash_fwd_kernel<__nv_bfloat16, 128>,
                    THREADS, 0};
        }
    }
    if (route == 1 && dtype == 1 && block_m == W_BM) {
        if (D == 64)
            return {(const void*)flash_fwd_wgmma_kernel<64>, W_THREADS,
                    w_smem<64>()};
        if (D == 128)
            return {(const void*)flash_fwd_wgmma_kernel<128>, W_THREADS,
                    w_smem<128>()};
    }
    return {nullptr, 0, 0};
}

}  // namespace

// q: [B, H, S, D]; k, v: [B, Hkv, T, D]; o: [B, H, S, D]; all contiguous.
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. route: 0
// = ffma (block_m 64), 1 = wgmma (bf16, D 64 or 128, block_m 64,
// 16-byte-aligned q, k, v and o), as the wrapper's plan() chose them.
// Returns the launch's cudaError_t (0 on success), cudaErrorInvalidValue
// for a shape or plan no kernel takes; never synchronises.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int S, int Tk, int D,
                                   int q_offset, int causal, int window,
                                   int dtype, int route, int block_m,
                                   void* stream) {
    if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || Tk <= 0
        || kernel_of(route, block_m, D, dtype).fn == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (route == 0) {
        if (dtype == 0)
            return (int)launch_dtype<float>(q, k, v, o, B, H, Hkv, S, Tk, D,
                                            q_offset, causal, window, st);
        return (int)launch_dtype<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S,
                                                Tk, D, q_offset, causal,
                                                window, st);
    }
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
        return (int)cudaErrorInvalidValue;
    if (D == 64)
        return (int)launch_wgmma<64>(q, k, v, o, B, H, Hkv, S, Tk, q_offset,
                                     causal, window, st);
    return (int)launch_wgmma<128>(q, k, v, o, B, H, Hkv, S, Tk, q_offset,
                                  causal, window, st);
}

// what the compiler gave the kernel of (route, block_m, D, dtype): out[0]
// registers a thread, out[1] local (spill) bytes a thread, out[2] static
// shared bytes, out[3] dynamic shared bytes a launch asks, out[4] threads
// a block. Returns a cudaError_t.
extern "C" int flash_attention_attributes(int route, int block_m, int D,
                                          int dtype, int* out) {
    const Kernel k = kernel_of(route, block_m, D, dtype);
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
