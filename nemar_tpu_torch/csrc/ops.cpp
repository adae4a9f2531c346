// The kernel library's PyTorch operators, torch.ops.nemar.*: the host side
// of every CUDA kernel's launches, one operator per kernel.
//
// ops/_build.py compiles this file with the CUDA sources into one library
// (nvcc against PyTorch's ATen and c10 headers, linked to c10, c10_cuda and
// torch_cpu) and loads it with torch.ops.load_library, which registers the
// operators. Each enters its tensors' device, calls the kernel's C launcher
// on PyTorch's current stream and raises on a CUDA error. The Python
// wrappers (ops/*.py) check what the kernels take, allocate the outputs and
// workspaces, and pass them here as the schema's mutable (!) tensors; the
// launchers take their shapes from the tensors. K-warp's, K-warp-bwd's,
// K-in's and K-in-bwd's operators allocate their outputs and workspaces
// themselves and do their own checks: at batch 1 their device time is a few
// microseconds, so the host path is what the caller waits for
// (chip_smoke.py prints both), and a torch.empty from Python costs more than
// one here.
//
// The --bf16 variants of K-block, K-block-bwd, K-convt, K-convt-bwd, K-in
// and K-in-bwd have operators of their own (*_bf16). Every operator checks
// each tensor's dtype and refuses, by the tensor's name, one of another
// type: a mix of bf16 and fp32 operands is an error, never converted.
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <cuda_bf16.h>

#include <cstdint>
#include <initializer_list>
#include <tuple>
#include <utility>

extern "C" {
int nemar_warp_grid_fwd(const float* img, const float* grid, float* out, int n, int h, int w, int c,
                        int ho, int wo, int padding, int align_corners, cudaStream_t stream);
long long nemar_warp_grid_bwd_work_words(int n, int ho, int wo);
int nemar_warp_grid_bwd(const float* img, const float* grid, const float* g, float* dimg,
                        float* dgrid, int* work, int n, int h, int w, int c, int ho, int wo, int gc,
                        int padding, int align_corners, cudaStream_t stream);
int nemar_resblock_fwd(const float* x, const float* w1, const float* w2, float* wsplit, float* y1,
                       float* y2, float* part, float* stats, float* out, int n, int h, int w, int c,
                       float eps, cudaStream_t stream);
int nemar_resblock_bwd(const float* x, const float* y1, const float* y2, const float* stats,
                       const float* g, const float* w1, const float* w2, float* wsplit, float* dz,
                       float* dpad, float* part_in, float* means, float* part_w, float* dw1,
                       float* dw2, float* dx, int n, int h, int w, int c, int splits,
                       cudaStream_t stream);
int nemar_conv_head_fwd(const float* x, const float* w, float* out, int n, int h, int wd, int ci,
                        int co, int tc, int blocks, cudaStream_t stream);
int nemar_conv_head_bwd(const float* x, const float* w, const float* g, float* part, float* frame,
                        float* dx, float* dw, int n, int h, int wd, int ci, int co, int tr, int tc,
                        int dw_blocks, int dx_blocks, cudaStream_t stream);
int nemar_convt_in_fwd(const float* x, const float* w, float* wsplit, float* yhat, float* part,
                       float* stats, float* out, int n, int h, int w_, int ci, int co, float eps,
                       cudaStream_t stream);
int nemar_convt_in_bwd(const float* x, const float* w, const float* yhat, const float* stats,
                       const float* g, float* wsplit, float* dz, float* part_in, float* means,
                       float* part_w, float* dw, float* dx, int n, int h, int w_, int ci, int co,
                       int splits, int pix_per_split, cudaStream_t stream);
long long nemar_in_act_fwd_work(int n, int hw, int c);
int nemar_in_act_fwd(const float* x, float* y, float* stats, double* work, long long work_doubles,
                     int n, int h, int w, int c, int act, float eps, float slope,
                     cudaStream_t stream);
long long nemar_in_act_bwd_work(int n, int hw, int c);
int nemar_in_act_bwd(const float* x, const float* g, const float* stats, float* dx, double* work,
                     long long work_doubles, int n, int h, int w, int c, int act, float slope,
                     cudaStream_t stream);
int nemar_resblock_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                            const __nv_bfloat16* w2, __nv_bfloat16* wt, __nv_bfloat16* pads,
                            float* y1,
                            __nv_bfloat16* y1hat, __nv_bfloat16* h1, float* y2, float* part,
                            float* stats, __nv_bfloat16* out, int n, int h, int w, int c, float eps,
                            cudaStream_t stream);
int nemar_resblock_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y1hat,
                            const __nv_bfloat16* h1, const float* y2, const float* stats,
                            const __nv_bfloat16* g, const __nv_bfloat16* w1,
                            const __nv_bfloat16* w2, __nv_bfloat16* pads, __nv_bfloat16* dz,
                            float* dpad, float* part_in,
                            float* means, float* part_w, __nv_bfloat16* dw1, __nv_bfloat16* dw2,
                            __nv_bfloat16* dx, int n, int h, int w, int c, int splits,
                            cudaStream_t stream);
int nemar_convt_in_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, float* part,
                            float* stats, __nv_bfloat16* yhat, __nv_bfloat16* out, int n, int h,
                            int w_, int ci, int co, float eps, cudaStream_t stream);
int nemar_convt_in_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                            const __nv_bfloat16* yhat, const float* stats, const __nv_bfloat16* g,
                            __nv_bfloat16* dz, float* part_in, float* means, float* part_w,
                            __nv_bfloat16* dw, __nv_bfloat16* dx, int n, int h, int w_, int ci,
                            int co, int splits, int pix_per_split, cudaStream_t stream);
long long nemar_in_act_fwd_bf16_work(int n, int hw, int c);
int nemar_in_act_fwd_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, float* stats, double* work,
                          long long work_doubles, int n, int h, int w, int c, int act, float eps,
                          float slope, cudaStream_t stream);
long long nemar_in_act_bwd_bf16_work(int n, int hw, int c);
int nemar_in_act_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g, const float* stats,
                          __nv_bfloat16* dx, double* work, long long work_doubles, int n, int h,
                          int w, int c, int act, float slope, cudaStream_t stream);
}

namespace {

float* f32(const at::Tensor& t) { return t.data_ptr<float>(); }
__nv_bfloat16* b16(const at::Tensor& t) {
  return reinterpret_cast<__nv_bfloat16*>(t.data_ptr<at::BFloat16>());
}

// Each named tensor of an operator has the dtype the kernel takes, else
// the operator raises naming it.
void dtypes(const char* what,
            std::initializer_list<std::pair<const char*, const at::Tensor*>> tensors,
            at::ScalarType want) {
  for (const auto& [name, t] : tensors)
    TORCH_CHECK(t->scalar_type() == want, what, ": ", name, " is ", t->scalar_type(),
                ", the kernel takes ", want);
}
int dim(const at::Tensor& t, int d) { return static_cast<int>(t.size(d)); }
cudaStream_t stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

void check(int code, const char* what) {
  TORCH_CHECK(code == 0, what, ": CUDA error ", code, " (",
              cudaGetErrorString(static_cast<cudaError_t>(code)), ")");
}

at::Tensor warp_grid(const at::Tensor& img_in, const at::Tensor& grid_in, int64_t padding,
                     bool align_corners) {
  const at::Tensor img = img_in.contiguous(), grid = grid_in.contiguous();
  TORCH_CHECK(img.is_cuda() && grid.device() == img.device(),
              "warp_grid: img and grid must lie on one CUDA device");
  TORCH_CHECK(img.scalar_type() == at::kFloat && grid.scalar_type() == at::kFloat,
              "warp_grid: the kernel takes float32 img and grid");
  TORCH_CHECK(img.dim() == 4 && grid.dim() == 4 && grid.size(0) == img.size(0) &&
                  grid.size(3) == 2,
              "warp_grid: bad grid ", grid.sizes(), " for image ", img.sizes());
  TORCH_CHECK(reinterpret_cast<std::uintptr_t>(grid.data_ptr()) % 8 == 0,
              "warp_grid: the kernel reads 8-byte aligned (x, y) pairs");
  TORCH_CHECK(padding >= 0 && padding <= 2, "warp_grid: padding ", padding, " not in [0, 2]");
  const c10::cuda::CUDAGuard guard(img.device());
  at::Tensor out = at::empty({img.size(0), grid.size(1), grid.size(2), img.size(3)}, img.options());
  check(nemar_warp_grid_fwd(f32(img), f32(grid), f32(out), dim(img, 0), dim(img, 1), dim(img, 2),
                            dim(img, 3), dim(grid, 1), dim(grid, 2), static_cast<int>(padding),
                            align_corners ? 1 : 0, stream()),
        "warp_grid");
  return out;
}

std::tuple<at::Tensor, at::Tensor> warp_grid_bwd(const at::Tensor& img, const at::Tensor& grid,
                                                 const at::Tensor& g, int64_t padding,
                                                 bool align_corners, int64_t grad_channels) {
  for (const at::Tensor* t : {&img, &grid, &g}) {
    TORCH_CHECK(t->is_cuda() && t->device() == img.device(),
                "warp_grid_bwd: img, grid and g must lie on one CUDA device");
    TORCH_CHECK(t->scalar_type() == at::kFloat, "warp_grid_bwd: the kernel takes float32 tensors");
    TORCH_CHECK(t->is_contiguous(), "warp_grid_bwd: the kernel takes contiguous tensors");
  }
  TORCH_CHECK(img.dim() == 4 && grid.dim() == 4 && grid.size(0) == img.size(0) &&
                  grid.size(3) == 2,
              "warp_grid_bwd: bad grid ", grid.sizes(), " for image ", img.sizes());
  TORCH_CHECK(g.dim() == 4 && g.size(0) == img.size(0) && g.size(1) == grid.size(1) &&
                  g.size(2) == grid.size(2) && g.size(3) == img.size(3),
              "warp_grid_bwd: bad g ", g.sizes(), " for image ", img.sizes(), " and grid ",
              grid.sizes());
  TORCH_CHECK(grad_channels >= 0 && grad_channels <= img.size(3) && grad_channels <= 256,
              "warp_grid_bwd: grad_channels ", grad_channels, " not in [0, min(C, 256)]");
  TORCH_CHECK(reinterpret_cast<std::uintptr_t>(grid.data_ptr()) % 8 == 0,
              "warp_grid_bwd: the kernel reads 8-byte aligned (x, y) pairs");
  TORCH_CHECK(padding >= 0 && padding <= 2, "warp_grid_bwd: padding ", padding, " not in [0, 2]");
  const c10::cuda::CUDAGuard guard(img.device());
  const int n = dim(img, 0), ho = dim(grid, 1), wo = dim(grid, 2);
  at::Tensor dgrid = at::empty(grid.sizes(), grid.options());
  // no output pixel adds to d img when the grid is empty
  at::Tensor dimg = !grad_channels     ? at::empty({0}, img.options())
                    : grid.numel() > 0 ? at::empty(img.sizes(), img.options())
                                       : at::zeros(img.sizes(), img.options());
  at::Tensor work = at::empty({nemar_warp_grid_bwd_work_words(n, ho, wo)},
                              img.options().dtype(at::kInt));
  check(nemar_warp_grid_bwd(f32(img), f32(grid), f32(g), grad_channels ? f32(dimg) : nullptr,
                            f32(dgrid), work.data_ptr<int>(), n, dim(img, 1), dim(img, 2),
                            dim(img, 3), ho, wo, static_cast<int>(grad_channels),
                            static_cast<int>(padding), align_corners ? 1 : 0, stream()),
        "warp_grid_bwd");
  return {dimg, dgrid};
}

void resblock_fwd(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2,
                  const at::Tensor& wsplit, const at::Tensor& y1, const at::Tensor& y2,
                  const at::Tensor& part, const at::Tensor& stats, const at::Tensor& out,
                  double eps) {
  dtypes("resblock_fwd", {{"x", &x}, {"w1", &w1}, {"w2", &w2}, {"y1", &y1}, {"y2", &y2},
                          {"out", &out}}, at::kFloat);
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_resblock_fwd(f32(x), f32(w1), f32(w2), f32(wsplit), f32(y1), f32(y2), f32(part),
                           f32(stats), f32(out), dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3),
                           static_cast<float>(eps), stream()),
        "resblock_fwd");
}

void resblock_bwd(const at::Tensor& x, const at::Tensor& y1, const at::Tensor& y2,
                  const at::Tensor& stats, const at::Tensor& g, const at::Tensor& w1,
                  const at::Tensor& w2, const at::Tensor& wsplit, const at::Tensor& dz,
                  const at::Tensor& dpad, const at::Tensor& part_in, const at::Tensor& means,
                  const at::Tensor& part_w, const at::Tensor& dw1, const at::Tensor& dw2,
                  const at::Tensor& dx, int64_t splits) {
  dtypes("resblock_bwd", {{"x", &x}, {"y1", &y1}, {"y2", &y2}, {"g", &g}, {"w1", &w1},
                          {"w2", &w2}, {"dw1", &dw1}, {"dw2", &dw2}, {"dx", &dx}}, at::kFloat);
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_resblock_bwd(f32(x), f32(y1), f32(y2), f32(stats), f32(g), f32(w1), f32(w2),
                           f32(wsplit), f32(dz), f32(dpad), f32(part_in), f32(means), f32(part_w),
                           f32(dw1), f32(dw2), f32(dx), dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3),
                           static_cast<int>(splits), stream()),
        "resblock_bwd");
}

// (tc, blocks) of ops/conv_head.py:head_fwd_plan: the wgmma route's strip
// width and grid, or blocks = 0 for the direct route
void conv_head_fwd(const at::Tensor& x, const at::Tensor& w, const at::Tensor& out, int64_t tc,
                   int64_t blocks) {
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_conv_head_fwd(f32(x), f32(w), f32(out), dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3),
                            dim(w, 3), static_cast<int>(tc), static_cast<int>(blocks), stream()),
        "conv_head_fwd");
}

// plan = (tr, tc, dw_blocks, dx_blocks) of ops/conv_head.py:head_bwd_plan,
// which also sizes part and frame
void conv_head_bwd(const at::Tensor& x, const at::Tensor& w, const at::Tensor& g,
                   const at::Tensor& part, const at::Tensor& frame, const at::Tensor& dx,
                   const at::Tensor& dw, int64_t tr, int64_t tc, int64_t dw_blocks,
                   int64_t dx_blocks) {
  const int64_t n = x.size(0), h = x.size(1), wd = x.size(2), ci = x.size(3), co = w.size(3);
  TORCH_CHECK(part.numel() >= dw_blocks * 49 * ci * co &&
                  frame.numel() >= n * (6 * (wd + 6) + 6 * h) * ci,
              "conv_head_bwd: part ", part.sizes(), " or frame ", frame.sizes(),
              " is smaller than the plan needs");
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_conv_head_bwd(f32(x), f32(w), f32(g), f32(part), f32(frame), f32(dx), f32(dw),
                            dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3), dim(w, 3),
                            static_cast<int>(tr), static_cast<int>(tc),
                            static_cast<int>(dw_blocks), static_cast<int>(dx_blocks), stream()),
        "conv_head_bwd");
}

void convt_in_fwd(const at::Tensor& x, const at::Tensor& w, const at::Tensor& wsplit,
                  const at::Tensor& yhat, const at::Tensor& part, const at::Tensor& stats,
                  const at::Tensor& out, double eps) {
  dtypes("convt_in_fwd", {{"x", &x}, {"w", &w}, {"yhat", &yhat}, {"out", &out}}, at::kFloat);
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_convt_in_fwd(f32(x), f32(w), f32(wsplit), f32(yhat), f32(part), f32(stats), f32(out),
                           dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3), dim(w, 3),
                           static_cast<float>(eps), stream()),
        "convt_in_fwd");
}

void convt_in_bwd(const at::Tensor& x, const at::Tensor& w, const at::Tensor& yhat,
                  const at::Tensor& stats, const at::Tensor& g, const at::Tensor& wsplit,
                  const at::Tensor& dz, const at::Tensor& part_in, const at::Tensor& means,
                  const at::Tensor& part_w, const at::Tensor& dw, const at::Tensor& dx,
                  int64_t splits, int64_t pix_per_split) {
  dtypes("convt_in_bwd", {{"x", &x}, {"w", &w}, {"yhat", &yhat}, {"g", &g}, {"dw", &dw},
                          {"dx", &dx}}, at::kFloat);
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_convt_in_bwd(f32(x), f32(w), f32(yhat), f32(stats), f32(g), f32(wsplit), f32(dz),
                           f32(part_in), f32(means), f32(part_w), f32(dw), f32(dx), dim(x, 0),
                           dim(x, 1), dim(x, 2), dim(x, 3), dim(w, 3), static_cast<int>(splits),
                           static_cast<int>(pix_per_split), stream()),
        "convt_in_bwd");
}

// K-in's and K-in-bwd's operand: fp32 (bf16 for the bf16 variants), (N, H,
// W, C) contiguous on a CUDA device
void check_nhwc(const char* what, const char* name, const at::Tensor& t, const at::Tensor& x,
                at::ScalarType want = at::kFloat) {
  TORCH_CHECK(t.is_cuda() && t.device() == x.device(), what, ": ", name,
              " must lie on x's CUDA device, not ", t.device());
  TORCH_CHECK(t.scalar_type() == want, what, ": ", name, " is ", t.scalar_type(),
              ", the kernel takes ", want);
  TORCH_CHECK(t.dim() == 4 && t.sizes() == x.sizes(), what, ": ", name, " ", t.sizes(),
              " must be (N, H, W, C) of x's shape ", x.sizes());
  TORCH_CHECK(t.is_contiguous(), what, ": ", name, " ", t.sizes(),
              " must be NHWC-contiguous, its strides are ", t.strides());
  TORCH_CHECK(t.size(1) * t.size(2) > 0 && t.size(3) > 0, what, ": ", name, " ", t.sizes(),
              " has no pixel or no channel");
}

void check_act(const char* what, int64_t act) {
  TORCH_CHECK(act >= 0 && act <= 2, what, ": act ", act, " not in [0, 2]");
}

// The workspace of one call, in doubles, from the launcher's own split.
at::Tensor in_act_work(long long words, const at::Tensor& x, const char* what) {
  if (words < 0) {
    (void)cudaGetLastError();  // the query's error is raised here, not by the next check
    check(static_cast<int>(-words), what);
  }
  return at::empty({words}, x.options().dtype(at::kDouble));
}

std::tuple<at::Tensor, at::Tensor> in_act_fwd(const at::Tensor& x, int64_t act, double eps,
                                              double slope) {
  check_nhwc("in_act_fwd", "x", x, x);
  check_act("in_act_fwd", act);
  const c10::cuda::CUDAGuard guard(x.device());
  const int n = dim(x, 0), h = dim(x, 1), w = dim(x, 2), c = dim(x, 3);
  at::Tensor work = in_act_work(nemar_in_act_fwd_work(n, h * w, c), x, "in_act_fwd");
  at::Tensor y = at::empty(x.sizes(), x.options());
  at::Tensor stats = at::empty({x.size(0), 2, x.size(3)}, x.options());
  const int code = nemar_in_act_fwd(f32(x), f32(y), f32(stats), work.data_ptr<double>(),
                                    work.numel(), n, h, w, c, static_cast<int>(act),
                                    static_cast<float>(eps), static_cast<float>(slope), stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  check(code, "in_act_fwd");
  return {y, stats};
}

void check_stats(const char* what, const at::Tensor& stats, const at::Tensor& x) {
  const int64_t n = x.size(0), c = x.size(3);
  TORCH_CHECK(stats.is_cuda() && stats.device() == x.device() &&
                  stats.scalar_type() == at::kFloat && stats.is_contiguous() &&
                  stats.dim() == 3 && stats.size(0) == n && stats.size(1) == 2 &&
                  stats.size(2) == c,
              what, ": stats ", stats.sizes(), " ", stats.scalar_type(),
              " must be contiguous fp32 (", n, ", 2, ", c, ") on x's device");
}

at::Tensor in_act_bwd(const at::Tensor& x, const at::Tensor& g, const at::Tensor& stats,
                      int64_t act, double slope) {
  check_nhwc("in_act_bwd", "x", x, x);
  check_nhwc("in_act_bwd", "g", g, x);
  check_act("in_act_bwd", act);
  const int n = dim(x, 0), h = dim(x, 1), w = dim(x, 2), c = dim(x, 3);
  check_stats("in_act_bwd", stats, x);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor work = in_act_work(nemar_in_act_bwd_work(n, h * w, c), x, "in_act_bwd");
  at::Tensor dx = at::empty(x.sizes(), x.options());
  const int code =
      nemar_in_act_bwd(f32(x), f32(g), f32(stats), f32(dx), work.data_ptr<double>(), work.numel(),
                       n, h, w, c, static_cast<int>(act), static_cast<float>(slope), stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  check(code, "in_act_bwd");
  return dx;
}

// ---------------------------------------------------------------------------
// the bf16 variants
// ---------------------------------------------------------------------------

void resblock_fwd_bf16(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2,
                       const at::Tensor& wt, const at::Tensor& pads, const at::Tensor& y1,
                       const at::Tensor& y1hat, const at::Tensor& h1, const at::Tensor& y2,
                       const at::Tensor& part, const at::Tensor& stats, const at::Tensor& out,
                       double eps) {
  dtypes("resblock_fwd_bf16", {{"x", &x}, {"w1", &w1}, {"w2", &w2}, {"wt", &wt},
                               {"pads", &pads}, {"y1hat", &y1hat}, {"h1", &h1}, {"out", &out}},
         at::kBFloat16);
  dtypes("resblock_fwd_bf16", {{"y1", &y1}, {"y2", &y2}, {"part", &part}, {"stats", &stats}},
         at::kFloat);
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_resblock_fwd_bf16(b16(x), b16(w1), b16(w2), b16(wt), b16(pads), f32(y1),
                                b16(y1hat), b16(h1), f32(y2), f32(part), f32(stats), b16(out), dim(x, 0), dim(x, 1),
                                dim(x, 2), dim(x, 3), static_cast<float>(eps), stream()),
        "resblock_fwd_bf16");
}

void resblock_bwd_bf16(const at::Tensor& x, const at::Tensor& y1hat, const at::Tensor& h1,
                       const at::Tensor& y2, const at::Tensor& stats, const at::Tensor& g,
                       const at::Tensor& w1, const at::Tensor& w2, const at::Tensor& pads,
                       const at::Tensor& dz, const at::Tensor& dpad, const at::Tensor& part_in,
                       const at::Tensor& means, const at::Tensor& part_w, const at::Tensor& dw1, const at::Tensor& dw2,
                       const at::Tensor& dx, int64_t splits) {
  dtypes("resblock_bwd_bf16", {{"x", &x}, {"y1hat", &y1hat}, {"h1", &h1}, {"g", &g},
                               {"w1", &w1}, {"w2", &w2}, {"pads", &pads}, {"dz", &dz},
                               {"dw1", &dw1}, {"dw2", &dw2}, {"dx", &dx}}, at::kBFloat16);
  dtypes("resblock_bwd_bf16", {{"y2", &y2}, {"stats", &stats}, {"dpad", &dpad},
                               {"part_in", &part_in}, {"means", &means}, {"part_w", &part_w}},
         at::kFloat);
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_resblock_bwd_bf16(b16(x), b16(y1hat), b16(h1), f32(y2), f32(stats), b16(g),
                                b16(w1), b16(w2), b16(pads), b16(dz), f32(dpad), f32(part_in),
                                f32(means), f32(part_w), b16(dw1), b16(dw2), b16(dx), dim(x, 0), dim(x, 1),
                                dim(x, 2), dim(x, 3), static_cast<int>(splits), stream()),
        "resblock_bwd_bf16");
}

void convt_in_fwd_bf16(const at::Tensor& x, const at::Tensor& w, const at::Tensor& part,
                       const at::Tensor& stats, const at::Tensor& yhat, const at::Tensor& out,
                       double eps) {
  dtypes("convt_in_fwd_bf16", {{"x", &x}, {"w", &w}, {"yhat", &yhat}, {"out", &out}},
         at::kBFloat16);
  dtypes("convt_in_fwd_bf16", {{"part", &part}, {"stats", &stats}}, at::kFloat);
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_convt_in_fwd_bf16(b16(x), b16(w), f32(part), f32(stats), b16(yhat), b16(out),
                                dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3), dim(w, 3),
                                static_cast<float>(eps), stream()),
        "convt_in_fwd_bf16");
}

void convt_in_bwd_bf16(const at::Tensor& x, const at::Tensor& w, const at::Tensor& yhat,
                       const at::Tensor& stats, const at::Tensor& g, const at::Tensor& dz,
                       const at::Tensor& part_in, const at::Tensor& means,
                       const at::Tensor& part_w, const at::Tensor& dw, const at::Tensor& dx,
                       int64_t splits, int64_t pix_per_split) {
  dtypes("convt_in_bwd_bf16", {{"x", &x}, {"w", &w}, {"yhat", &yhat}, {"g", &g}, {"dz", &dz},
                               {"dw", &dw}, {"dx", &dx}}, at::kBFloat16);
  dtypes("convt_in_bwd_bf16", {{"stats", &stats}, {"part_in", &part_in}, {"means", &means},
                               {"part_w", &part_w}}, at::kFloat);
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_convt_in_bwd_bf16(b16(x), b16(w), b16(yhat), f32(stats), b16(g), b16(dz),
                                f32(part_in), f32(means), f32(part_w), b16(dw), b16(dx),
                                dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3), dim(w, 3),
                                static_cast<int>(splits), static_cast<int>(pix_per_split),
                                stream()),
        "convt_in_bwd_bf16");
}

std::tuple<at::Tensor, at::Tensor> in_act_fwd_bf16(const at::Tensor& x, int64_t act, double eps,
                                                   double slope) {
  check_nhwc("in_act_fwd_bf16", "x", x, x, at::kBFloat16);
  check_act("in_act_fwd_bf16", act);
  const c10::cuda::CUDAGuard guard(x.device());
  const int n = dim(x, 0), h = dim(x, 1), w = dim(x, 2), c = dim(x, 3);
  at::Tensor work = in_act_work(nemar_in_act_fwd_bf16_work(n, h * w, c), x, "in_act_fwd_bf16");
  at::Tensor y = at::empty(x.sizes(), x.options());
  at::Tensor stats = at::empty({x.size(0), 2, x.size(3)}, x.options().dtype(at::kFloat));
  const int code = nemar_in_act_fwd_bf16(b16(x), b16(y), f32(stats), work.data_ptr<double>(),
                                         work.numel(), n, h, w, c, static_cast<int>(act),
                                         static_cast<float>(eps), static_cast<float>(slope),
                                         stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  check(code, "in_act_fwd_bf16");
  return {y, stats};
}

at::Tensor in_act_bwd_bf16(const at::Tensor& x, const at::Tensor& g, const at::Tensor& stats,
                           int64_t act, double slope) {
  check_nhwc("in_act_bwd_bf16", "x", x, x, at::kBFloat16);
  check_nhwc("in_act_bwd_bf16", "g", g, x, at::kBFloat16);
  check_act("in_act_bwd_bf16", act);
  check_stats("in_act_bwd_bf16", stats, x);
  const int n = dim(x, 0), h = dim(x, 1), w = dim(x, 2), c = dim(x, 3);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor work = in_act_work(nemar_in_act_bwd_bf16_work(n, h * w, c), x, "in_act_bwd_bf16");
  at::Tensor dx = at::empty(x.sizes(), x.options());
  const int code = nemar_in_act_bwd_bf16(b16(x), b16(g), f32(stats), b16(dx),
                                         work.data_ptr<double>(), work.numel(), n, h, w, c,
                                         static_cast<int>(act), static_cast<float>(slope),
                                         stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  check(code, "in_act_bwd_bf16");
  return dx;
}

}  // namespace

TORCH_LIBRARY(nemar, m) {
  m.def("warp_grid(Tensor img, Tensor grid, int padding, bool align_corners) -> Tensor",
        &warp_grid);
  m.def("warp_grid_bwd(Tensor img, Tensor grid, Tensor g, int padding, bool align_corners, "
        "int grad_channels) -> (Tensor, Tensor)",
        &warp_grid_bwd);
  m.def("resblock_fwd(Tensor x, Tensor w1, Tensor w2, Tensor(a!) wsplit, Tensor(b!) y1, "
        "Tensor(c!) y2, Tensor(d!) part, Tensor(e!) stats, Tensor(f!) out, float eps) -> ()",
        &resblock_fwd);
  m.def("resblock_bwd(Tensor x, Tensor y1, Tensor y2, Tensor stats, Tensor g, Tensor w1, "
        "Tensor w2, Tensor(a!) wsplit, Tensor(b!) dz, Tensor(c!) dpad, Tensor(d!) part_in, "
        "Tensor(e!) means, Tensor(f!) part_w, Tensor(g!) dw1, Tensor(h!) dw2, Tensor(i!) dx, "
        "int splits) -> ()",
        &resblock_bwd);
  m.def("conv_head_fwd(Tensor x, Tensor w, Tensor(a!) out, int tc, int blocks) -> ()",
        &conv_head_fwd);
  m.def("conv_head_bwd(Tensor x, Tensor w, Tensor g, Tensor(a!) part, Tensor(b!) frame, "
        "Tensor(c!) dx, Tensor(d!) dw, int tr, int tc, int dw_blocks, int dx_blocks) -> ()",
        &conv_head_bwd);
  m.def("convt_in_fwd(Tensor x, Tensor w, Tensor(a!) wsplit, Tensor(b!) yhat, Tensor(c!) part, "
        "Tensor(d!) stats, Tensor(e!) out, float eps) -> ()",
        &convt_in_fwd);
  m.def("convt_in_bwd(Tensor x, Tensor w, Tensor yhat, Tensor stats, Tensor g, "
        "Tensor(a!) wsplit, Tensor(b!) dz, Tensor(c!) part_in, Tensor(d!) means, "
        "Tensor(e!) part_w, Tensor(f!) dw, Tensor(g!) dx, int splits, int pix_per_split) -> ()",
        &convt_in_bwd);
  m.def("in_act_fwd(Tensor x, int act, float eps, float slope) -> (Tensor y, Tensor stats)",
        &in_act_fwd);
  m.def("in_act_bwd(Tensor x, Tensor g, Tensor stats, int act, float slope) -> Tensor dx",
        &in_act_bwd);
  m.def("resblock_fwd_bf16(Tensor x, Tensor w1, Tensor w2, Tensor(a!) wt, Tensor(i!) pads, "
        "Tensor(b!) y1, Tensor(c!) y1hat, Tensor(d!) h1, Tensor(e!) y2, Tensor(f!) part, "
        "Tensor(g!) stats, Tensor(h!) out, float eps) -> ()",
        &resblock_fwd_bf16);
  m.def("resblock_bwd_bf16(Tensor x, Tensor y1hat, Tensor h1, Tensor y2, Tensor stats, "
        "Tensor g, Tensor w1, Tensor w2, Tensor(i!) pads, Tensor(a!) dz, Tensor(b!) dpad, "
        "Tensor(c!) part_in, "
        "Tensor(d!) means, Tensor(e!) part_w, Tensor(f!) dw1, Tensor(g!) dw2, Tensor(h!) dx, "
        "int splits) -> ()",
        &resblock_bwd_bf16);
  m.def("convt_in_fwd_bf16(Tensor x, Tensor w, Tensor(a!) part, Tensor(b!) stats, "
        "Tensor(c!) yhat, Tensor(d!) out, float eps) -> ()",
        &convt_in_fwd_bf16);
  m.def("convt_in_bwd_bf16(Tensor x, Tensor w, Tensor yhat, Tensor stats, Tensor g, "
        "Tensor(a!) dz, Tensor(b!) part_in, Tensor(c!) means, Tensor(d!) part_w, Tensor(e!) dw, "
        "Tensor(f!) dx, int splits, int pix_per_split) -> ()",
        &convt_in_bwd_bf16);
  m.def("in_act_fwd_bf16(Tensor x, int act, float eps, float slope) -> (Tensor y, Tensor stats)",
        &in_act_fwd_bf16);
  m.def("in_act_bwd_bf16(Tensor x, Tensor g, Tensor stats, int act, float slope) -> Tensor dx",
        &in_act_bwd_bf16);
}
