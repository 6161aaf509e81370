// Hopper (sm_90a) building blocks shared by the port's kernels: shared-memory
// addresses, mbarriers, TMA loads and stores, wgmma descriptors and fences,
// and the driver's tensor-map encoder reached through the runtime, so that
// no library links libcuda. Included by dpa_matmul.cu and
// flash_attention.cu; kernels/build.py hashes it into each library's name.
#pragma once

#include <cuda.h>              // CUtensorMap and its enums; no libcuda call
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("{\n.reg .b64 state;\n"
                 "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// the box of a 2-D `map` at (c0 inner, c1 outer) into shared `dst`;
// completes its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(bar)
        : "memory");
}

// the same for a 3-D `map` at (c0 inner, c1, c2 outer)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(c2), "r"(bar)
        : "memory");
}

// shared `src` into the box of a 3-D `map` at (c0, c1, c2); the parts of
// the box past the tensor's bounds are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0,
                                          int c1, int c2, uint32_t src) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
        "[%0, {%1, %2, %3}], [%4];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
           "r"(src)
        : "memory");
}

// commits this thread's TMA stores and waits until they have read shared
// memory
__device__ __forceinline__ void tma_store_drain() {
    asm volatile("cp.async.bulk.commit_group;\n"
                 "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's generic stores to shared memory before later reads
// of it by the TMA unit
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units. K-major: the stride is
// 1024 bytes between groups of 8 rows (the leading offset is unused).
// MN-major: the leading offset steps between 64-column boxes, the stride
// between groups of 8 k rows.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
           | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// the driver's cuTensorMapEncodeTiled, through the runtime's entry-point
// lookup (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        return e == cudaSuccess && q == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// a contiguous bf16 tensor of `rank` dims (`dims` innermost first) in boxes
// of 64 inner elements (128 bytes) by `box_rows` by 1 ..., 128-byte swizzle,
// zeros past the tensor on loads
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, int box_rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr || rank < 2 || rank > 5) return false;
    cuuint64_t strides[4];
    cuuint32_t box[5], step[5];
    cuuint64_t stride = 2;
    for (int i = 0; i < rank; ++i) {
        if (i > 0) strides[i - 1] = stride;
        stride *= dims[i];
        box[i] = i == 0 ? 64 : i == 1 ? (cuuint32_t)box_rows : 1;
        step[i] = 1;
    }
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
              const_cast<void*>(base), dims, strides, box, step,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace sm90
