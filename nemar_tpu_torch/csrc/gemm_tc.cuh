// The 3xTF32 tensor-core GEMM core of the kernel library: K-block
// (resblock_fwd.cu), K-block-bwd (resblock_bwd.cu), K-convt (convt_fwd.cu)
// and K-convt-bwd (convt_bwd.cu). K-head (head_fwd.cu) and K-head-bwd
// (head_bwd.cu) have GEMMs of their own shapes and use only the helpers
// below (the split, the swizzle, the descriptor, the wgmma wrappers,
// cp.async).
//
// Both kernels compute a 128-row tile of C = A B, 128 or 64 columns wide
// (Op::kTileN), over K in 32-deep slices, with two warpgroups (256 threads):
// warpgroup w computes rows 64 w .. 64 w + 63 with wgmma.mma_async
// m64n128k8 (or m64n64k8) tf32, A from registers (each warp's 16 x 8
// fragment, split there), B from shared memory through a matrix
// descriptor, in the K-major 128-byte-swizzled layout wgmma reads for TF32:
// a row (n) holds the slice's 32 k in 128 bytes, its 16-byte chunks
// permuted by XOR with n % 8, and 8-row groups are 1024 bytes apart. A ring
// of STAGES slices in dynamic shared memory is filled by cp.async (16 bytes
// a copy, zero-filled where the Op masks a row: src-size 0); slice
// kt + STAGES - 1 is in flight while slice kt is multiplied. An Op
// (resblock_{fwd,bwd}.cu, convt_{fwd,bwd}.cu) supplies the operands'
// addresses, masks and layouts and the epilogue's writes.
//
//   gemm_wgmma_kernel: operands both K-major in device memory (the dgrads:
//     dz along channels, W in HWIO; the forward's convs: the activation
//     along channels, W^T per tap). A is copied as rows of 32 k (+ 4
//     floats of pad) and read by ldmatrix; B is split before the GEMM (the
//     weights: big and small arrays) and copied straight into the swizzled
//     layout. With Op::kTileStats the epilogue also reduces the tile's
//     valid rows to per-column (mean, sum of squared deviations) for the
//     instance norm (tile_stats).
//   gemm_wgmma_mn_kernel: A M-major, B N-major (the wgrads: the pixels,
//     their K, are outermost in both). Both are copied as rows of 128 (+ 8
//     floats of pad); per slice each thread transposes and splits chunks
//     of B (4 k of one n: column reads, 16-byte swizzled writes) into the
//     big and small tiles, and reads its A fragments as 8-byte loads (its
//     two rows of a fragment are adjacent tile rows: the epilogue maps them
//     back). A 64-wide tile uses the first 64 columns of the B tiles.
//
// 3xTF32. Each fp32 value x is split into big = tf32(x) (round to nearest,
// ties away, as cvt.rna.tf32.f32, with two integer ops) and small = x - big
// (exact in fp32; the tensor core reads its top 19 bits). A product is three
// MMAs, always in this order, into a chain that spans one K slice (4 steps
// x 3 = 12 wgmma's), added at the end of the slice to the fp32 total:
//     part = small_a * big_b (first), or part += small_a * big_b;
//     part += big_a * small_b;  part += big_a * big_b;   ... 4 times, then
//     acc += part;   (IEEE fp32)
// The dropped small_a * small_b term is below 2^-22 of |a b|. The tensor
// core's own accumulation rounds toward zero: chained over a whole K of 2304
// that bias alone cost 2.5e-5 of the largest value on the H100, 70x the
// fp32 plain version's error (test_block_bwd_kernel_fp64_accuracy in
// tests/test_torch_cuda_kernels.py on a single-chain build); chains of 12
// MMAs keep it to the fp32 level. tests/test_torch_tf32_split.py emulates
// this order, with each MMA rounding toward zero, and holds both: 32-deep
// chains within 2e-6 of the largest value, one chain over K beyond it. On
// the card, chip_smoke.py's rel_err_vs_fp64 (phase 2b) holds the kernel. It
// costs 3x the tensor core's operations (495 / 3 = 165 TFLOP/s fp32-
// equivalent at the TF32 peak) and a second accumulator of 64 registers.
// 1xTF32 (big_a * big_b alone) keeps 10 mantissa bits and misses fp32 by
// ~3e-4 of the largest value at K = 2304; it is not used. (A first version
// on mma.sync m16n8k8 ran slower: there every split, add and load a warp
// issues beside its MMAs costs tensor time; a wgmma of 64 x 128 x 8 is one
// instruction for a warpgroup.)
//
// Deterministic: every output is one thread's fixed sequence of MMAs and
// adds; no atomics. An Op with kNormRelu has its A values rebuilt as
// relu((v - mu) * rstd) before the split, with (mu, rstd) per A row and per
// sample of the K slice (gemm_wgmma_mn_kernel), or per K column, copied
// beside the slice (gemm_wgmma_kernel).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

// Everything is internal to each translation unit that includes this.
namespace tc {
namespace {

constexpr int BM = 128;      // output rows per block tile
constexpr int BN = 128;      // output columns per block tile
constexpr int BK = 32;       // reduction depth per stage
constexpr int THREADS = 256; // two warpgroups, 64 rows each
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int KSTRIDE = BK + 4;  // K-major A tile: floats per row (m)
constexpr int MSTRIDE = BM + 8;  // M/N-major tile: floats per row (k)
static_assert(BM == BN, "one M/N-major row length for both operands");

// floats of one operand tile in shared memory
__host__ __device__ constexpr int tile_floats(bool kmajor) {
  return kmajor ? BM * KSTRIDE : BK * MSTRIDE;
}

// 16-byte chunks a thread copies per tile: K-major, chunk q = tid + 256 i
// is row q / 8, k 4 (q % 8); M/N-major, k row q / 32, columns 4 (q % 32).
constexpr int CHUNKS = BM * BK / 4 / THREADS;  // 4
__device__ __forceinline__ int kmajor_row(int tid, int i) { return (tid >> 3) + 32 * i; }
__device__ __forceinline__ int kmajor_k(int tid) { return (tid & 7) * 4; }
__device__ __forceinline__ int mmajor_k(int tid, int i) { return (tid >> 5) + 8 * i; }
__device__ __forceinline__ int mmajor_col(int tid) { return (tid & 31) * 4; }
__device__ __forceinline__ float* kmajor_at(float* tile, int row, int k) { return tile + row * KSTRIDE + k; }
__device__ __forceinline__ float* mmajor_at(float* tile, int k, int col) { return tile + k * MSTRIDE + col; }

// 16 bytes from device to shared memory, asynchronously; zeros when !valid
// (src is then not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(float* smem, const float* src, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// big = tf32(x) rounded to nearest, ties away (cvt.rna.tf32.f32's rounding,
// done with two integer ops); small = x - big, exact in fp32, whose low 13
// bits the tensor core ignores (truncation: at most 2^-11 of small, 2^-22
// of x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Four 8x8 matrices of 16-bit elements from shared memory, lane l giving
// the address of row l % 8 of matrix l / 8: on 32-bit data, the register q
// of lane l holds element (l / 4, l % 4) of the q-th 8 x 4 block, which is
// the layout of a warp's 16 x 8 tf32 A fragment of wgmma (A from registers).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

constexpr int WG_B_FL = BN * BK;  // floats of one swizzled K-major B tile

// float offset of the 16-byte chunk (n, k-group kg) of a swizzled B tile
__device__ __forceinline__ int swizzled_off(int n, int kg) {
  return n * BK + ((kg ^ (n & 7)) << 2);
}

// K-major, 128-byte swizzle, 8-row groups 1024 bytes apart; p at k within
// the row (the tile itself 1024-byte aligned)
__device__ __forceinline__ uint64_t kmajor_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d = a b + (accumulate ? d : 0), m64n128k8, fp32 += tf32 x tf32
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

// the same, m64n64k8 (a 64-column tile)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

// the same, m64n80k8 (K-head-bwd's weight gradient: two warpgroups of 80
// columns over the 49 x Co taps, head_bwd.cu)
__device__ __forceinline__ void wgmma_tf32(float (&d)[40], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

// the same, m64n32k8 (K-head-bwd's input gradient at Co > 3: 32 input
// channels a block, head_bwd.cu)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

// the same, m64n56k8, m64n104k8 and m64n152k8 (K-head's GEMM, head_fwd.cu:
// N = 49 Co rounded up to 8, at Co = 1, 2, 3)
__device__ __forceinline__ void wgmma_tf32(float (&d)[28], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[52], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51}, "
      "{%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[76], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75}, "
      "{%76, %77, %78, %79}, %80, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}

// keep the compiler from moving reads or writes of d across the asynchronous wgmma's
template <int N>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

constexpr int NORM_FL = 2 * BK;  // (mu, rstd) of a K slice's 32 channels

// The tile's per-column mean and sum of squared deviations over its first
// op.rows_in_tile() rows, in a fixed order: each thread's two rows, then the
// 8 lanes of a warp that share a column (butterfly), then the 8 warps in
// order through shared memory (red: 8 x TN + TN floats, free by now); tid
// counts the 256 threads that hold the tile.
// the barrier tile_stats syncs its threads with: the block's, or (kNamed)
// named barrier 1 over the bf16 core's 256 consumer threads
template <bool kNamed>
__device__ __forceinline__ void stats_sync() {
  if constexpr (kNamed) {
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

template <int TN, class Op, bool kNamed = false>
__device__ __forceinline__ void tile_stats(const Op& op, const float (&acc)[TN / 2], float* red,
                                           int tid, int row0, int g, int t) {
  const int warp = tid >> 5, lane = tid & 31, nrows = op.rows_in_tile();
  const bool v0 = row0 + g < nrows, v1 = row0 + g + 8 < nrows;
  float* mean = red + 8 * TN;
  float s[TN / 4];
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      s[2 * j + e] = (v0 ? acc[4 * j + e] : 0.f) + (v1 ? acc[4 * j + 2 + e] : 0.f);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < TN / 4; ++i)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) red[warp * TN + 8 * j + 2 * t + e] = s[2 * j + e];
    }
    stats_sync<kNamed>();
    if (tid < TN) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[w * TN + tid];
      if (pass == 0) mean[tid] = sum / (float)nrows;
      else op.write_stats(tid, mean[tid], sum);
    }
    stats_sync<kNamed>();
    if (pass == 0) {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = mean[8 * j + 2 * t + e];
          const float d0 = acc[4 * j + e] - m, d1 = acc[4 * j + 2 + e] - m;
          s[2 * j + e] = (v0 ? d0 * d0 : 0.f) + (v1 ? d1 * d1 : 0.f);
        }
    }
  }
}

// A and B K-major (the dgrads, the forward's convolutions); see the header.
template <class Op>
__global__ void __launch_bounds__(THREADS, 1) gemm_wgmma_kernel(const Op params) {
  constexpr int TN = Op::kTileN;  // the tile's columns: 128, or 64 to fill the card
  constexpr int B_FL = TN * BK;   // floats of one swizzled K-major B tile
  static_assert(TN == 128 || TN == 64, "wgmma m64n128k8 or m64n64k8");
  static_assert(tile_floats(true) * 4 % 1024 == 0 && B_FL * 4 % 1024 == 0,
                "1024-byte aligned B tiles");
  extern __shared__ __align__(1024) float4 smem4[];
  constexpr int A_FL = tile_floats(true);
  constexpr int STAGE_FL = A_FL + 2 * B_FL;
  float* smem = reinterpret_cast<float*>(smem4);
  float* norm = smem + STAGES * STAGE_FL;  // STAGES x NORM_FL when Op::kNormRelu
  Op op = params;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;  // warpgroup warp >> 2 owns rows 64 (warp >> 2) .. + 63
  op.setup(tid);
  const int ktiles = op.ktiles();

  float acc[TN / 2], part[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;

  // The loads are written out per branch: with a shared lambda, the dgrad's
  // kernel (no kNormRelu) compiled to another HGMMA schedule (PERF.md).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    float* st = smem + s * STAGE_FL;
    if constexpr (Op::kNormRelu) {
      if (s < ktiles) op.load(s, st, st + A_FL, st + A_FL + B_FL, norm + s * NORM_FL, tid);
    } else {
      if (s < ktiles) op.load(s, st, st + A_FL, st + A_FL + B_FL, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // slice kt landed for all; slice kt - 1's stage is free
    {
      const int nk = kt + STAGES - 1;
      float* st = smem + (nk % STAGES) * STAGE_FL;
      if constexpr (Op::kNormRelu) {
        if (nk < ktiles)
          op.load(nk, st, st + A_FL, st + A_FL + B_FL, norm + (nk % STAGES) * NORM_FL, tid);
      } else {
        if (nk < ktiles) op.load(nk, st, st + A_FL, st + A_FL + B_FL, tid);
      }
      cp_async_commit();
    }
    const float* As = smem + (kt % STAGES) * STAGE_FL;
    const float* Bb = As + A_FL;
    const float* Bs = Bb + B_FL;
    uint32_t abig[BK / 8][4], asmall[BK / 8][4];
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      uint32_t r[4];
      ldsm_x4(r, As + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * KSTRIDE + 8 * s + (lane >> 4) * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = __uint_as_float(r[q]);
        if constexpr (Op::kNormRelu) {
          // register q holds k = 8 s + t + 4 (q / 2) of the slice
          const float* ns = norm + (kt % STAGES) * NORM_FL + 8 * s + t + 4 * (q >> 1);
          v = fmaxf((v - ns[0]) * ns[BK], 0.f);
        }
        split_tf32(v, abig[s][q], asmall[s][q]);
      }
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_fence_operand(part);
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const uint64_t db = kmajor_desc(Bb + 8 * s), ds = kmajor_desc(Bs + 8 * s);
      wgmma_tf32(part, asmall[s], db, s > 0);
      wgmma_tf32(part, abig[s], ds, 1);
      wgmma_tf32(part, abig[s], db, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_fence_operand(part);
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  // epilogue: d[4 j + v] is row g (v < 2) or g + 8, column 8 j + 2 t + (v & 1)
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    op.write(row0 + g, 8 * j + 2 * t, make_float2(acc[4 * j], acc[4 * j + 1]));
    op.write(row0 + g + 8, 8 * j + 2 * t, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
  }
  if constexpr (Op::kTileStats) {
    __syncthreads();  // every warp is done with the ring
    tile_stats<TN>(op, acc, smem, tid, row0, g, t);
  }
}

// Launch gemm_wgmma_kernel<Op> on grid, with its ring in dynamic shared memory.
template <class Op>
cudaError_t launch_wgmma(const Op& op, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = (STAGES * (tile_floats(true) + 2 * Op::kTileN * BK) +
                         (Op::kNormRelu ? STAGES * NORM_FL : 0)) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(gemm_wgmma_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  gemm_wgmma_kernel<Op><<<grid, THREADS, bytes, stream>>>(op);
  return cudaGetLastError();
}

// A M-major, B N-major (the wgrads); see the header.
template <class Op>
__global__ void __launch_bounds__(THREADS, 1) gemm_wgmma_mn_kernel(const Op params) {
  constexpr int TN = Op::kTileN;  // the tile's columns: 128, or 64 for 64 output channels
  static_assert(TN == 128 || TN == 64, "wgmma m64n128k8 or m64n64k8");
  extern __shared__ __align__(1024) float4 smem4[];
  constexpr int T_FL = tile_floats(false);
  constexpr int STAGE_FL = 2 * T_FL;
  float* Bb = reinterpret_cast<float*>(smem4);  // 2 x WG_B_FL: B big, small, K-major
  float* Bsm = Bb + WG_B_FL;
  float* ring = Bsm + WG_B_FL;                  // STAGES x (A, B) as copied
  Op op = params;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // warp w's 16 rows start at 16 w; its fragment rows g, g + 8 are 2g, 2g + 1
  const int row0 = 16 * warp;
  op.setup(tid);
  const int ktiles = op.ktiles();

  float acc[TN / 2], part[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  float nmu[2] = {0.f, 0.f}, nrs[2] = {0.f, 0.f};
  int cur_sample = -1;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    float* st = ring + s * STAGE_FL;
    if (s < ktiles) op.load(s, st, st + T_FL, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt landed for all; slice kt - 1's stage and B tiles are free
    {
      const int nk = kt + STAGES - 1;
      float* st = ring + (nk % STAGES) * STAGE_FL;
      if (nk < ktiles) op.load(nk, st, st + T_FL, tid);
      cp_async_commit();
    }
    const float* As = ring + (kt % STAGES) * STAGE_FL;
    const float* Bst = As + T_FL;
    // B: chunk q = tid + 256 i is (n = q % TN, k-group q / TN)
#pragma unroll
    for (int i = 0; i < TN * BK / 4 / THREADS; ++i) {
      const int q = tid + THREADS * i, n = q & (TN - 1), kg = q / TN;
      uint32_t big[4], sm[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(Bst[(4 * kg + j) * MSTRIDE + n], big[j], sm[j]);
      const int off = swizzled_off(n, kg);
      *reinterpret_cast<uint4*>(Bb + off) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(Bsm + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
    if constexpr (Op::kNormRelu) {
      const int sample = op.sample_of(kt);
      if (sample != cur_sample) {
        cur_sample = sample;
#pragma unroll
        for (int h = 0; h < 2; ++h) op.norm_params(sample, row0 + 2 * g + h, nmu[h], nrs[h]);
      }
    }
    uint32_t abig[BK / 8][4], asmall[BK / 8][4];
#pragma unroll
    for (int s = 0; s < BK / 8; ++s)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(As + (8 * s + t + 4 * r) * MSTRIDE + row0 + 2 * g);
        float av[2] = {v.x, v.y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if constexpr (Op::kNormRelu) av[h] = fmaxf((av[h] - nmu[h]) * nrs[h], 0.f);
          split_tf32(av[h], abig[s][2 * r + h], asmall[s][2 * r + h]);
        }
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the B tiles are written
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_fence_operand(part);
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const uint64_t db = kmajor_desc(Bb + 8 * s), ds = kmajor_desc(Bsm + 8 * s);
      wgmma_tf32(part, asmall[s], db, s > 0);
      wgmma_tf32(part, abig[s], ds, 1);
      wgmma_tf32(part, abig[s], db, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_fence_operand(part);
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();

  // epilogue: d[4 j + v] is fragment row g (v < 2) or g + 8, i.e. tile row
  // row0 + 2g or row0 + 2g + 1, column 8 j + 2 t + (v & 1)
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    op.write(row0 + 2 * g, 8 * j + 2 * t, make_float2(acc[4 * j], acc[4 * j + 1]));
    op.write(row0 + 2 * g + 1, 8 * j + 2 * t, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
  }
}

template <class Op>
cudaError_t launch_wgmma_mn(const Op& op, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = (2 * WG_B_FL + STAGES * 2 * tile_floats(false)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gemm_wgmma_mn_kernel<Op>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  gemm_wgmma_mn_kernel<Op><<<grid, THREADS, bytes, stream>>>(op);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 (--bf16): one warp-specialised, persistent wgmma core, one MMA a product
// ---------------------------------------------------------------------------
//
// gemm_bf16_kernel computes 128-row tiles of C = A B, 128 or 64 columns wide
// (Op::kTileN), over K in 64-deep slices (a slice's row of 64 bf16 is 128
// bytes, one row of the 128-byte swizzle), for every bf16 Op: the operands
// K-major (the convolutions and dgrads) or, with Op::kMN, A M-major and B
// N-major (the wgrads: the pixels, their K, outermost in both), or with
// Op::kMNB A K-major and B N-major (K-convt-bf16's W as it lies, Co
// innermost).
//
// What bounds it: at bf16 a 128 x 128 x 64 slice is 2.1 MFLOP, 0.28 us of an
// SM at the card's 989 TFLOP/s, so whatever a slice does beside its four
// MMAs shows. The design keeps the tensor core fed:
//
//   Warp specialisation (384 threads). Warpgroup 0 is the producer: it gives
//     up its registers (setmaxnreg 40) and fills a ring of STAGES slices (A
//     tile, then B tile; 6 at 128 columns, 8 at 64) in dynamic shared
//     memory. Warpgroups 1 and 2 are the consumers (setmaxnreg 232): each
//     multiplies 64 rows of the tile. A full and an empty mbarrier per stage
//     replace the block-wide barrier of each slice: the producer waits for
//     a stage's empty barrier (its 8 consumer warps' arrivals), loads it,
//     and the loads complete its full barrier; a consumer waits for the full
//     barrier and releases the stage when its MMAs are done.
//   Loads that cost the consumers nothing. Where the Op's operand tile is a
//     box of a tensor (Op::tma_a, tma_b), one producer thread issues it as a
//     TMA copy (cp.async.bulk.tensor, 128-byte swizzle: exactly the layout
//     wgmma reads) that completes the full barrier by its byte count: the
//     weights (2-D), the wgrads' dz (3-D: out-of-bounds pixels are zeros),
//     and the convolutions' and wgrads' reflect-padded sources (4-D boxes
//     of whole image rows). Every other tile (a dgrad's dz shifted by the
//     tap over the padded output domain, the band forms' sources, K-convt's
//     parity planes) is copied by the producer's 128 threads with cp.async,
//     16 bytes a copy, each thread's copies arriving on the same full
//     barrier when they land (cp.async.mbarrier.arrive.noinc).
//   One slice's MMAs in flight. A consumer issues slice k's four
//     m64n128k16 (or m64n64k16) MMAs into one of two chains (part0, part1),
//     commits them, waits until only that group is in flight
//     (wgmma.wait_group 1), then adds slice k - 1's chain to the fp32 total
//     and releases slice k - 1's stage, while slice k runs.
//   A persistent grid: min(tiles, SMs) blocks walking the tiles in a fixed
//     order (tile t: column tile t % gy, then row tile, then split; block
//     i takes tile i of each round of gridDim.x tiles, the rounds in
//     alternate directions), so one tile's epilogue (its stores,
//     tile_stats) overlaps the producer's loads of the next, and at b1 the
//     64-column tiles fill the SMs.
//
// Accuracy: chains of 4 MMAs (one slice, 64 deep), added to the fp32 total
// in slice order. The tensor core's own accumulation rounds toward zero, so
// one chain over the whole K would bias the sum; chains of 4 keep it at the
// fp32 level (tests/test_torch_bf16_core.py emulates this schedule and holds
// it against float64; chip_smoke.py's phases 2 and 2b hold each operator).
// There is no big/small split: a bf16 x bf16 product is exact in the fp32
// accumulator, so the error is the inputs' rounding to bf16, the caller's.
// Every output is one consumer thread's fixed sequence of MMAs and adds,
// whichever block computes its tile: deterministic, no atomics.
//
// Layouts in shared memory (1024-byte aligned tiles):
//   K-major: a tile is rows of 128 bytes, the 16-byte chunk kg of row r at
//     r * 128 + ((kg ^ (r % 8)) << 4) (swz16); 8-row groups 1024 bytes
//     apart (descriptor SBO). Consumer w reads A's rows 64 w .. 64 w + 63,
//     step s at byte 32 s of the row.
//   MN-major: wgmma takes the operands as they lie, through the
//     descriptor's transpose bit: a 1024-byte atom holds 8 k rows of 64 MN
//     values (128 bytes each, chunks swizzled by the row as above); atoms
//     along MN are 8192 bytes apart (LBO), along K 1024 (SBO): atom (j, q) =
//     MN values 64 j .., k rows 8 q .. (mn16).
//
// An Op may store its tiles itself (kTileEpilogue, tile_epilogue(), off in
// Bf16Loads): it gets each consumer thread's fp32 totals. K-convt-bf16's
// second pass and K-convt-bwd-bf16's dgrad store bf16 16 bytes a lane after
// a transpose within each quad of lanes (tc::quad_transpose,
// store_bf16_rows), so that a warp's stores cover whole 32-byte sectors
// where the fragment's 4-byte column pairs would write half sectors.
//
// An Op supplies: kTileN, kMN, kTileStats; setup(ptid, tile) (the tile's
// coordinates, and the producer thread ptid's copies); ktiles(); load()
// (its cp.async copies, producer threads) and load_tma() (its TMA boxes,
// one thread); write() and, with kTileStats, rows_in_tile() and
// write_stats() for the epilogue, which gets the fp32 totals before any
// rounding. Its tma_a, tma_b say which tiles are boxes (Bf16Loads).
constexpr int BK16 = 64;                  // reduction depth per stage, bf16 values
constexpr int A16_BYTES = BM * BK16 * 2;  // one 128-row operand tile: 16 KB
constexpr int WS_THREADS = 384;           // the producer warpgroup, then two consumers
constexpr int PTHREADS = 128;             // the producer's threads
constexpr int PCHUNKS = BM * 8 / PTHREADS;  // 16-byte chunks of a 128-row tile a producer thread copies

// K-major tile row of the producer thread's chunk i (its chunk column ptid % 8)
__device__ __forceinline__ int prow(int ptid, int i) { return (ptid >> 3) + 16 * i; }

// byte offset of the 16-byte chunk (row r, chunk kg) of a K-major swizzled tile
__device__ __forceinline__ int swz16(int r, int kg) { return r * 128 + ((kg ^ (r & 7)) << 4); }

// byte offset of the 16-byte chunk (k row k, chunk c of the 128 MN values)
// of an MN-major tile of 64 k rows
__device__ __forceinline__ int mn16(int k, int c) {
  return ((c >> 3) * 8 + (k >> 3)) * 1024 + (k & 7) * 128 + (((c & 7) ^ (k & 7)) << 4);
}

// 16 bytes from device to shared memory, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16b(void* smem, const void* src, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

// 128-byte-swizzle descriptor at p (the tile 1024-byte aligned), with the
// leading and stride byte offsets lbo, sbo
__device__ __forceinline__ uint64_t desc16(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// d = a b + (accumulate ? d : 0), m64n128k16 (or m64n64k16), fp32 += bf16 x
// bf16, A and B through descriptors, each K-major (kTransA, kTransB 0) or
// MN-major (1)
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB)
      : "memory");
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB)
      : "memory");
}

// mbarriers in shared memory, and the copies that complete them
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// one arrival that also expects `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// an arrival when this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// TMA: the box of `map` at the coordinates (innermost first) into dst,
// completing `bar` by its bytes (zeros where the box leaves the tensor)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// The tensor maps of an Op's TMA boxes (unused ones left zero), a kernel
// parameter (__grid_constant__: TMA reads them in parameter space).
struct TmaMaps {
  CUtensorMap a, b, a2;  // a2: A's boxes of a second shape (K-block-bwd's dgrad's edge tiles)
};

// Which of an Op's operand tiles are TMA boxes; the others are copied by
// the producer's threads with cp.async. The full barrier of a stage counts
// one arrival (with the boxes' bytes) for the boxes and one per producer
// thread for the copies.
// kTileEpilogue: the Op stores a tile itself (tile_epilogue(acc, row0, g,
// t), every consumer thread with its fragment) in place of write(); an Op
// that does shadows it.
struct Bf16Loads {
  static constexpr bool kTileEpilogue = false;
  static constexpr bool kMNB = false;  // B N-major beside a K-major A (kMN false)
  bool tma_a = false, tma_b = false;
  __device__ bool copies() const { return !(tma_a && tma_b); }
  __device__ int full_arrivals() const { return (copies() ? PTHREADS : 0) + (tma_a || tma_b); }
};

template <int TN>
__host__ __device__ constexpr int stage16_bytes() { return A16_BYTES + TN * BK16 * 2; }
// the ring's depth: 192 KB of slices (6 at 128 columns, 8 at 64)
template <int TN>
__host__ __device__ constexpr int stages16() { return 192 * 1024 / stage16_bytes<TN>(); }
template <int TN>
__host__ __device__ constexpr int smem16_bytes() {
  return stages16<TN>() * stage16_bytes<TN>() + 9 * TN * 4 + 2 * stages16<TN>() * 8;
}

// tile t of the walk over the grid g: the column tile fastest, then the
// row tile, then the split (the coordinates an Op reads as its block's)
__device__ __forceinline__ uint3 tile_at(int t, uint3 g) {
  uint3 b;
  b.y = t % g.y;
  t /= g.y;
  b.x = t % g.x;
  b.z = t / g.x;
  return b;
}

// A ring position: stage s, and the parity of its current phase
struct RingPos {
  int s = 0;
  uint32_t ph = 0;
  template <int S>
  __device__ __forceinline__ void next() {
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  }
};

// One slice of a consumer: wait for its stage, issue its four MMAs into the
// chain `issue`, then, with slice k - 1's MMAs done (wait_group 1), add its
// chain `done` to acc and release its stage (`prev`). A and B K-major or
// MN-major by kTransA, kTransB.
template <int kTransA, int kTransB, int TN, int S>
__device__ __forceinline__ void mma_slice(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                          RingPos& pos, int& prev, bool add, bool fence_copies,
                                          int wg, int lane, float (&issue)[TN / 2],
                                          float (&done)[TN / 2], float (&acc)[TN / 2]) {
  constexpr int STAGE = stage16_bytes<TN>();
  mbar_wait(full + pos.s, pos.ph);
  // cp.async copies are generic-proxy writes; wgmma reads through the async proxy
  if (fence_copies) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const unsigned char* As = smem + pos.s * STAGE;
  const unsigned char* Bs = As + A16_BYTES;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_fence_operand(issue);
#pragma unroll
  for (int k = 0; k < BK16 / 16; ++k) {
    const uint64_t da = kTransA == 0 ? desc16(As + wg * 64 * 128 + 32 * k, 16, 1024)
                                     : desc16(As + wg * 8192 + 2048 * k, 8192, 1024);
    const uint64_t db = kTransB == 0 ? desc16(Bs + 32 * k, 16, 1024)
                                     : desc16(Bs + 2048 * k, 8192, 1024);
    wgmma_bf16<kTransA, kTransB>(issue, da, db, k > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  wgmma_fence_operand(done);
  if (add) {
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] += done[i];
    if (lane == 0) mbar_arrive(empty + prev);
  }
  prev = pos.s;
  pos.next<S>();
}

// A consumer's tile: acc = the fp32 total over the tile's ktiles slices,
// chains of one slice added in slice order.
template <int kTransA, int kTransB, int TN, int S>
__device__ __forceinline__ void mma_tile(int ktiles, unsigned char* smem, uint64_t* full,
                                         uint64_t* empty, RingPos& pos, bool fence_copies, int wg,
                                         int lane, float (&acc)[TN / 2]) {
  float part0[TN / 2], part1[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = part0[i] = part1[i] = 0.f;
  int prev = 0;
  for (int kt = 0; kt < ktiles; kt += 2) {
    mma_slice<kTransA, kTransB, TN, S>(smem, full, empty, pos, prev, kt > 0, fence_copies, wg,
                                       lane, part0, part1, acc);
    if (kt + 1 < ktiles)
      mma_slice<kTransA, kTransB, TN, S>(smem, full, empty, pos, prev, true, fence_copies, wg,
                                         lane, part1, part0, acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wgmma_fence_operand(part0);
  wgmma_fence_operand(part1);
  if (ktiles > 0) {
    if (ktiles & 1) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] += part0[i];
    } else {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] += part1[i];
    }
    if (lane == 0) mbar_arrive(empty + prev);
  }
}

// The persistent walk: block i's w-th tile, rounds of gridDim.x tiles
// taken in alternate directions (snake), so that where tiles differ in
// length (K-convt's parity planes, 1-4 taps) each block's sum evens out.
__device__ __forceinline__ int walk_tile(int w) {
  const int g = gridDim.x, i = blockIdx.x;
  return w * g + ((w & 1) ? g - 1 - i : i);
}

template <class Op>
__global__ void __launch_bounds__(WS_THREADS, 1)
    gemm_bf16_kernel(const __grid_constant__ Op params, const __grid_constant__ TmaMaps maps,
                     const uint3 grid) {
  constexpr int TN = Op::kTileN;
  constexpr int kTransA = Op::kMN ? 1 : 0, kTransB = Op::kMN || Op::kMNB ? 1 : 0;
  constexpr int S = stages16<TN>(), STAGE = stage16_bytes<TN>();
  static_assert(TN == 128 || TN == 64, "wgmma m64n128k16 or m64n64k16");
  static_assert(S >= 3, "a slice in flight, one being added, one loading");
  extern __shared__ __align__(1024) uint4 smem16[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem16);
  float* red = reinterpret_cast<float*>(smem + S * STAGE);  // tile_stats: 9 TN floats
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 9 * TN);
  uint64_t* empty = full + S;
  const int ntiles = (int)(grid.x * grid.y * grid.z);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, params.full_arrivals());
      mbar_init(empty + s, 8);  // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup, uniform to ptxas (a branch on threadIdx.x / 128 would
  // serialise the wgmma's: note C7518)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  if (role == 0) {
    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    Op op = params;
    const int ptid = threadIdx.x;
    const uint32_t tx = (op.tma_a ? A16_BYTES : 0) + (op.tma_b ? TN * BK16 * 2 : 0);
    // an Op of boxes alone needs one thread: the other warps leave, so
    // that no idle warp polls the ring beside the consumers
    if (!op.copies() && ptid >= 32) return;
    RingPos pos;
    for (int w = 0, t = walk_tile(0); t < ntiles; t = walk_tile(++w)) {
      op.setup(ptid, tile_at(t, grid));
      const int ktiles = op.ktiles();
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty + pos.s, pos.ph ^ 1);
        unsigned char* st = smem + pos.s * STAGE;
        if (tx != 0 && ptid == 0) {
          mbar_expect_tx(full + pos.s, tx);
          op.load_tma(kt, st, st + A16_BYTES, full + pos.s, maps);
        }
        if (op.copies()) {
          op.load(kt, st, st + A16_BYTES, ptid);
          cp_async_arrive(full + pos.s);
        }
        pos.next<S>();
      }
    }
    cp_async_wait<0>();
  } else {
    // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    Op op = params;
    const int wg = role - 1, ctid = threadIdx.x - PTHREADS;
    const int lane = ctid & 31, g = lane >> 2, t4 = lane & 3;
    const int row0 = 16 * (ctid >> 5);
    const bool fence_copies = op.copies();
    RingPos pos;
    for (int w = 0, t = walk_tile(0); t < ntiles; t = walk_tile(++w)) {
      op.setup(0, tile_at(t, grid));
      float acc[TN / 2];
      mma_tile<kTransA, kTransB, TN, S>(op.ktiles(), smem, full, empty, pos, fence_copies, wg,
                                        lane, acc);
      // epilogue: acc[4 j + v] is row g (v < 2) or g + 8, column 8 j + 2 t + (v & 1)
      if constexpr (Op::kTileEpilogue) {
        op.tile_epilogue(acc, row0, g, t4);
      } else {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          op.write(row0 + g, 8 * j + 2 * t4, make_float2(acc[4 * j], acc[4 * j + 1]));
          op.write(row0 + g + 8, 8 * j + 2 * t4, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
        }
      }
      if constexpr (Op::kTileStats) tile_stats<TN, Op, true>(op, acc, red, ctid, row0, g, t4);
    }
  }
}

// Launch gemm_bf16_kernel<Op> over the tiles of `grid` (the Op's tile
// coordinates), persistent: min(tiles, SMs) blocks of 384 threads.
template <class Op>
cudaError_t launch_bf16(const Op& op, dim3 grid, cudaStream_t stream,
                        const TmaMaps& maps = TmaMaps{}) {
  constexpr int bytes = smem16_bytes<Op::kTileN>();
  const long long ntiles = (long long)grid.x * grid.y * grid.z;
  if (ntiles == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_bf16_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(ntiles < sms ? ntiles : sms);
  gemm_bf16_kernel<Op><<<blocks, WS_THREADS, bytes, stream>>>(op, maps,
                                                             make_uint3(grid.x, grid.y, grid.z));
  return cudaGetLastError();
}


// A TMA map over a contiguous bf16 tensor: `rank` dims, innermost first,
// read in boxes of `box`, 128-byte swizzled (the box's innermost extent 64
// values), zeros outside the tensor. cuTensorMapEncodeTiled is the
// driver's, found in libcuda at first use. A refused encode is an error.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank, const long long* dims,
                            const int* box) {
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], ones[5];
  cuuint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    bdim[i] = (cuuint32_t)box[i];
    ones[i] = 1;
    if (i + 1 < rank) gstride[i] = stride *= (cuuint64_t)dims[i];
  }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                        const_cast<void*>(base), gdim, gstride, bdim, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps the Ops read: W (9C rows of C, K-major along the inner C) in
// boxes of 64 x rows; an image (N, H, W, C), or a reflect-padded copy as
// (N, H + 2, W + 2, C), in boxes of 64 channels x bw x bh pixels; a
// gradient (N, H W, C) in boxes of 64 channels x 64 pixels.
inline cudaError_t weight_map(CUtensorMap* map, const void* w, int c, int rows) {
  const long long dims[2] = {c, 9LL * c};
  const int box[2] = {BK16, rows};
  return bf16_map(map, w, 2, dims, box);
}
inline cudaError_t image_map(CUtensorMap* map, const void* src, int n, int h, int w, int c,
                             int bw, int bh) {
  const long long dims[4] = {c, w, h, n};
  const int box[4] = {BK16, bw, bh, 1};
  return bf16_map(map, src, 4, dims, box);
}
inline cudaError_t pixels_map(CUtensorMap* map, const void* src, int n, int hw, int c) {
  const long long dims[3] = {c, hw, n};
  const int box[3] = {BK16, BK16, 1};
  return bf16_map(map, src, 3, dims, box);
}

// 4 adjacent values in and out, in fp32 registers: fp32 as 16 bytes, bf16
// as 8 (widened on the load, rounded on the store)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&a);
  q.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// One value widened to fp32.
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// An fp32 value as an element of type T holds it: itself for fp32, rounded
// to bf16 (and widened back) for bf16.
template <class T>
__device__ __forceinline__ float rounded(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16(v));
  }
}
template <class T>
__device__ __forceinline__ float4 rounded(float4 v) {
  return make_float4(rounded<T>(v.x), rounded<T>(v.y), rounded<T>(v.z), rounded<T>(v.w));
}

// Two fp32 values rounded to bf16, as one 32-bit word (the lower column first).
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Within each quad of lanes (lane t = lane % 4), a 4 x 4 transpose of
// 32-bit words: lane t's w[k] becomes lane k's w[t] (two butterflies).
// An epilogue whose lane t holds columns 8 j + 2 t, + 1 of the chunks
// j = 4 q .. 4 q + 3 (the wgmma fragment) then holds all 8 columns of chunk
// 4 q + t, a 16-byte store.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int t) {
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, (t & 1) ? w[k] : w[k + 1], 1);
    if (t & 1) w[k] = recv;
    else w[k + 1] = recv;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t recv = __shfl_xor_sync(0xffffffffu, (t & 2) ? w[k] : w[k + 2], 2);
    if (t & 2) w[k] = recv;
    else w[k + 2] = recv;
  }
}

// A consumer thread's fragment of a TN-column tile stored in bf16, 16 bytes
// a lane: after a quad transpose of the rounded column pairs, lane t writes
// the 8 columns of chunk 4 q + t of rows g (at p0) and g + 8 (at p1), where
// the row is the tile's (p0, p1 null past it) and the chunk's columns below
// ncols (a multiple of 8); p0, p1 16-byte aligned.
template <int TN>
__device__ __forceinline__ void store_bf16_rows(const float (&acc)[TN / 2], int t,
                                                __nv_bfloat16* p0, __nv_bfloat16* p1,
                                                int ncols) {
#pragma unroll
  for (int q = 0; q < TN / 32; ++q) {
    uint32_t w0[4], w1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;
      w0[k] = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
      w1[k] = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    quad_transpose(w0, t);
    quad_transpose(w1, t);
    const int col = 8 * (4 * q + t);
    if (col < ncols) {
      if (p0) *reinterpret_cast<uint4*>(p0 + col) = make_uint4(w0[0], w0[1], w0[2], w0[3]);
      if (p1) *reinterpret_cast<uint4*>(p1 + col) = make_uint4(w1[0], w1[1], w1[2], w1[3]);
    }
  }
}

// The sum over the kGroups threads of a channel lane (a block of kGroups x
// kCh threads, thread = group * kCh + lane) of v, in a fixed order: a
// pairwise tree through red (kGroups x kCh doubles); every thread gets its
// lane's sum.
template <int kGroups, int kCh>
__device__ __forceinline__ double group_sum(double (&red)[kGroups][kCh], double v, int grp,
                                            int lane) {
  red[grp][lane] = v;
#pragma unroll
  for (int half = kGroups / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (grp < half) red[grp][lane] += red[grp + half][lane];
  }
  __syncthreads();
  const double sum = red[0][lane];
  __syncthreads();
  return sum;
}

// The epilogue's store of two adjacent columns: fp32, or rounded to bf16.
__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

}  // namespace
}  // namespace tc
