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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// order through shared memory (red: 8 x TN + TN floats, free by now).
template <int TN, class Op>
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
    __syncthreads();
    if (tid < TN) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[w * TN + tid];
      if (pass == 0) mean[tid] = sum / (float)nrows;
      else op.write_stats(tid, mean[tid], sum);
    }
    __syncthreads();
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
// bf16 (--bf16): the same two kernels with bf16 operands, one MMA a product
// ---------------------------------------------------------------------------
//
// gemm_bf16_kernel (operands K-major, as gemm_wgmma_kernel's) and
// gemm_bf16_mn_kernel (A M-major and B N-major, as gemm_wgmma_mn_kernel's)
// compute the same 128-row tiles of C = A B, 128 or 64 columns wide, over K
// in 64-deep slices: a slice's row of 64 bf16 is 128 bytes, one row of the
// 128-byte swizzle. Both operands are copied by cp.async (16 bytes, 8
// values, zero-filled where the Op masks them) straight into the layouts
// wgmma reads from shared memory, and each warpgroup issues
// wgmma.mma_async m64n128k16 (or m64n64k16) .f32.bf16.bf16 with A and B
// both through matrix descriptors: four MMAs a slice, one per 16-deep step,
// into a chain that spans the slice, added at the end of the slice to the
// fp32 total as in 3xTF32 (the tensor core's own accumulation rounds toward
// zero; chains of 4 keep that bias to the fp32 level: chip_smoke.py's phase
// 2b holds each operator against float64 from the same bf16 inputs). There
// is no big/small split: a bf16 x bf16 product is exact in the fp32
// accumulator, so the error is the inputs' rounding to bf16, the caller's.
//
//   K-major (gemm_bf16_kernel): a tile is rows of 128 bytes, the 16-byte
//     chunk kg of row r at r * 128 + ((kg ^ (r % 8)) << 4) (swz16); 8-row
//     groups 1024 bytes apart (descriptor SBO). Warpgroup w reads A's rows
//     64 w .. 64 w + 63, step s at byte 32 s of the row.
//   MN-major (gemm_bf16_mn_kernel): the wgrads' operands have the pixels (K)
//     outermost and 128 channels (M or N) contiguous. wgmma takes them as
//     they lie, through the descriptor's transpose bit: a 1024-byte atom
//     holds 8 k rows of 64 MN values (128 bytes each, chunks swizzled by the
//     row as above); atoms along MN are 8192 bytes apart (LBO), along K
//     1024 (SBO): atom (j, q) = MN values 64 j .., k rows 8 q .. (mn16).
//
// The epilogue and tile_stats are the fp32 kernels': the fp32 accumulators
// are the Op's to write (in fp32 or rounded to bf16, as the Op stores) and
// to reduce, before any rounding. No Op of the bf16 kernels has kNormRelu:
// the bf16 K-block materialises h1 = relu(IN(y1)) in bf16 (the JAX kernel
// rounds it there too) and its backward reads it.
constexpr int BK16 = 64;                  // reduction depth per stage, bf16 values
constexpr int A16_BYTES = BM * BK16 * 2;  // one 128-row operand tile: 16 KB

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
// bf16, A and B through descriptors, both K-major (kTrans 0) or both
// MN-major (kTrans 1)
template <int kTrans>
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
      "%64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTrans)
      : "memory");
}

template <int kTrans>
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
      "%32, %33, p, 1, 1, %35, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTrans)
      : "memory");
}

// The MMA loop both bf16 kernels share: a ring of STAGES slices (A tile,
// then B tile), slice kt + STAGES - 1 in flight while slice kt is
// multiplied; kTrans 0 reads K-major tiles, 1 MN-major ones.
template <int kTrans, class Op, int TN>
__device__ __forceinline__ void bf16_mainloop(const Op& op, unsigned char* smem, int tid,
                                              float (&acc)[TN / 2]) {
  constexpr int STAGE_BYTES = A16_BYTES + TN * BK16 * 2;
  // the warpgroup, uniform to ptxas (a branch on threadIdx.x / 128 would
  // serialise the wgmma's: note C7518)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int ktiles = op.ktiles();
  float part[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    unsigned char* st = smem + s * STAGE_BYTES;
    if (s < ktiles) op.load(s, st, st + A16_BYTES, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // slice kt landed for all; slice kt - 1's stage is free
    {
      const int nk = kt + STAGES - 1;
      unsigned char* st = smem + (nk % STAGES) * STAGE_BYTES;
      if (nk < ktiles) op.load(nk, st, st + A16_BYTES, tid);
      cp_async_commit();
    }
    const unsigned char* As = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* Bs = As + A16_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma_fence_operand(part);
#pragma unroll
    for (int s = 0; s < BK16 / 16; ++s) {
      uint64_t da, db;
      if constexpr (kTrans == 0) {
        da = desc16(As + wg * 64 * 128 + 32 * s, 16, 1024);
        db = desc16(Bs + 32 * s, 16, 1024);
      } else {
        da = desc16(As + wg * 8192 + 2048 * s, 8192, 1024);
        db = desc16(Bs + 2048 * s, 8192, 1024);
      }
      wgmma_bf16<kTrans>(part, da, db, s > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wgmma_fence_operand(part);
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();
}

// A and B K-major, bf16 (the bf16 convolutions and dgrads); see above.
template <class Op>
__global__ void __launch_bounds__(THREADS, 1) gemm_bf16_kernel(const Op params) {
  constexpr int TN = Op::kTileN;
  static_assert(TN == 128 || TN == 64, "wgmma m64n128k16 or m64n64k16");
  static_assert(!Op::kNormRelu, "the bf16 operands are materialised");
  extern __shared__ __align__(1024) uint4 smem16[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem16);
  Op op = params;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;  // warpgroup warp >> 2 owns rows 64 (warp >> 2) .. + 63
  op.setup(tid);
  float acc[TN / 2];
  bf16_mainloop<0, Op, TN>(op, smem, tid, acc);
  // epilogue: d[4 j + v] is row g (v < 2) or g + 8, column 8 j + 2 t + (v & 1)
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    op.write(row0 + g, 8 * j + 2 * t, make_float2(acc[4 * j], acc[4 * j + 1]));
    op.write(row0 + g + 8, 8 * j + 2 * t, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
  }
  if constexpr (Op::kTileStats) {
    __syncthreads();  // every warp is done with the ring
    tile_stats<TN>(op, acc, reinterpret_cast<float*>(smem), tid, row0, g, t);
  }
}

template <class Op>
cudaError_t launch_bf16(const Op& op, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = STAGES * (A16_BYTES + Op::kTileN * BK16 * 2);
  cudaError_t err =
      cudaFuncSetAttribute(gemm_bf16_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  gemm_bf16_kernel<Op><<<grid, THREADS, bytes, stream>>>(op);
  return cudaGetLastError();
}

// A M-major, B N-major, bf16 (the bf16 wgrads): both read by wgmma as they
// lie (the transpose bit); see above.
template <class Op>
__global__ void __launch_bounds__(THREADS, 1) gemm_bf16_mn_kernel(const Op params) {
  constexpr int TN = Op::kTileN;
  static_assert(TN == 128 || TN == 64, "wgmma m64n128k16 or m64n64k16");
  static_assert(!Op::kNormRelu, "the bf16 operands are materialised");
  extern __shared__ __align__(1024) uint4 smem16[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem16);
  Op op = params;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;
  op.setup(tid);
  float acc[TN / 2];
  bf16_mainloop<1, Op, TN>(op, smem, tid, acc);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    op.write(row0 + g, 8 * j + 2 * t, make_float2(acc[4 * j], acc[4 * j + 1]));
    op.write(row0 + g + 8, 8 * j + 2 * t, make_float2(acc[4 * j + 2], acc[4 * j + 3]));
  }
}

template <class Op>
cudaError_t launch_bf16_mn(const Op& op, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = STAGES * (A16_BYTES + Op::kTileN * BK16 * 2);
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_mn_kernel<Op>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  gemm_bf16_mn_kernel<Op><<<grid, THREADS, bytes, stream>>>(op);
  return cudaGetLastError();
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

// The epilogue's store of two adjacent columns: fp32, or rounded to bf16.
__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

}  // namespace
}  // namespace tc
