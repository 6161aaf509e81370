// Flash attention forward for Hopper (sm_90a), first design: right and simple.
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
//   * D in {16, 32, 64, 128} as template instances;
//   * KV tiles past the causal edge (or before the window) are skipped.
//
// What bounds it. At the slice's prefill shapes (granite-20b: H=48, Hkv=1,
// D=128, S a bucket of up to 256 rows, T=512) q and o (S*H*D each) dominate
// the bytes, since the 48:1 cache is one head; each query row does 4*D
// operations per visible key against 4*D bytes of q and o, so the intensity
// is the number of visible keys per row (~130 for a cold 256-row prefill),
// below the card's ~295 operations per byte: the bound is bytes, near the
// ridge, and a few microseconds. This design does the arithmetic in f32 FMA
// on the CUDA cores (true f32 for f32 inputs, no TF32) over a grid of only
// B*H*ceil(S/64) blocks, so it runs some 70x above that bound; mma/wgmma
// tiles, TMA staging and warp specialisation are the next design's work.
//
// Layout: one block of 256 threads per (batch*head, 64-row query tile).
// Four consecutive lanes share a query row; each owns D/4 of its dims in
// float4 chunks interleaved so the four lanes read one contiguous 64-byte
// span of a shared-memory key row (no bank conflicts). Scores are reduced
// across the four lanes with two xor-shuffles. KV tiles of 32 keys are
// staged through shared memory as f32. Registers hold q, the accumulator,
// the tile's 32 scores and the online-softmax state.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

}  // namespace

// q: [B, H, S, D]; k, v: [B, Hkv, T, D]; o: [B, H, S, D]; all contiguous.
// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns the launch's cudaError_t (0 on success); never synchronises.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Hkv, int S, int Tk,
                                   int D, int q_offset, int causal, int window,
                                   int dtype, void* stream) {
    if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || Tk <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch_dtype<float>(q, k, v, o, B, H, Hkv, S, Tk, D,
                                        q_offset, causal, window, st);
    if (dtype == 1)
        return (int)launch_dtype<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, Tk,
                                                D, q_offset, causal, window, st);
    return (int)cudaErrorInvalidValue;
}
