// Hopper (sm_90a) building blocks in inline PTX, for kernels that feed the
// tensor cores from a ring of TMA loads: mbarriers, TMA tensor loads and
// stores (cp.async.bulk.tensor), 1-D bulk copies, the wgmma shared-memory
// descriptor for the 128-byte swizzle, and wgmma m64n256k16 (bf16 in, f32
// sums) with either operand K-major or MN-major ("transposed"), and the
// warp-level mma.sync m16n8k16 with its ldmatrix loads. Used by the bf16
// kernels S, E and T in moe_gmm.cu, by kernel L's streaming form
// (linear_q4.cuh), by kernel F in bf16 (moe_decode.cu) and by the bf16
// walk of kernels B and V (flash_attention.cu).
//
// Layout conventions (the ones TMA writes with CU_TENSOR_MAP_SWIZZLE_128B):
// a box whose inner dimension is 64 bf16 (128 bytes) lands in shared memory
// as 128-byte rows, the 16-byte chunk j of row r stored at chunk j ^ (r % 8);
// 8 rows make a 1024-byte swizzle atom, so every box starts on a 1024-byte
// boundary. wgmma reads the same layout through a descriptor (desc_sw128):
// - K-major operand (rows along M or N, 64 k a row): SBO = 1024 bytes from
//   one 8-row group to the next; a k16 step adds 32 bytes to the start.
// - MN-major operand (rows along K, 64 m or n a row): SBO = 1024 bytes from
//   one 8-k group to the next, LBO = the distance to the box holding the
//   next 64 m or n; a k16 step adds 16 rows, 2048 bytes, to the start.
//
// The host half builds the tensor maps with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint so the library needs no -lcuda; a map is
// passed to the kernel by value as a __grid_constant__ const CUtensorMap.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums, for their types only
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier. A wait on parity p returns once the phase of that parity has
// completed: a fresh barrier is in phase 0, so a wait on parity 1 passes at
// once (a producer's first wait on an empty slot) and a wait on parity 0
// blocks until the first phase completes.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// After the inits, before any thread (or TMA) uses the barriers; then a
// __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transfers in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// A wait that has not returned after this many SM clocks (several seconds)
// can only be a schedule that never arrives: the kernel traps, and its
// launch reports an error, instead of hanging the card.
constexpr long long kWaitTrapClocks = 20000000000LL;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > kWaitTrapClocks) {
      __trap();
    }
  }
}

// A named barrier over `threads` threads (one warpgroup: 128), id 1-15.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// TMA. Loads complete on an mbarrier (the full box's bytes count, zeros
// included where the box passes the tensor's edge); stores go out in bulk
// groups and are clipped at the tensor's edge.

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory, completing on an mbarrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Wait until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N committed store groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of ordinary stores made visible to TMA (the async
// proxy): each writing thread, before the barrier that precedes the store.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// wgmma

// Descriptor of a 128-byte-swizzled operand at `smem` (1024-byte aligned,
// or offset from such a base by a k step): start address, leading and
// stride byte offsets in 16-byte units, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A descriptor moved by `bytes` (a multiple of 16) along its start address.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) { return desc + (bytes >> 4); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (before the first mma and after the wait).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] B[16 x 256], f32 sums, on one warpgroup.
// TA / TB = 0: the operand is K-major; 1: MN-major (transposed). Thread t
// of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 h and columns
// 8 j + 2 (t % 4) + c in d[4 j + 2 h + c] (j < 32, h, c < 2).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TA), "n"(TB));
}

// ---------------------------------------------------------------------------
// Warp-level products: mma.sync m16n8k16 (bf16 in, f32 sums) and the
// ldmatrix loads that feed it (kernels B and V in bf16, F in bf16).
//
// Fragments (lane = 4 g + t): A [16 x 16] a0 (row g, k 2t, 2t + 1), a1 (row
// g + 8, the same k), a2 (row g, k 2t + 8, 2t + 9), a3 (row g + 8, those
// k); B [16 x 8] b0 (k 2t, 2t + 1, n g), b1 (k 2t + 8, 2t + 9, n g); C c0,
// c1 (row g, n 2t, 2t + 1), c2, c3 (row g + 8, the same n). Each register
// holds two bf16, the lower k in the low half.

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit values: lanes 8 j .. 8 j + 7 give the
// addresses (16-byte aligned) of rows 0-7 of matrix j, and r[j] receives
// the lane's pair (row g, columns 2t, 2t + 1) of matrix j; `_trans`
// delivers the transpose, (rows 2t, 2t + 1, column g).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

// ---------------------------------------------------------------------------
// Host: tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A tiled map of a dense row-major tensor at `base` (16-byte aligned): dims
// innermost first, each row 16-byte aligned; box[i] elements per dim, the
// inner one at most 128 bytes (the swizzle span); 128-byte swizzle; loads
// past an edge read zeros. Returns 0 or a CUDA error code.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, int rank, const void* base,
                    const uint64_t* dims, const uint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t gbox[5], estride[5];
  uint64_t stride = elem_bytes;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = stride *= dims[i];
  }
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), gdim, gstride, gbox, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
