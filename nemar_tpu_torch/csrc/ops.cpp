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
// launchers take their shapes from the tensors. K-warp's operator allocates
// its output itself and does its own checks: at batch 1 its device time is
// a few microseconds, so its host path is what the caller waits for
// (chip_smoke.py prints both), and a torch.empty from Python costs more
// than one here.
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>

extern "C" {
int nemar_warp_grid_fwd(const float* img, const float* grid, float* out, int n, int h, int w, int c,
                        int ho, int wo, int padding, int align_corners, cudaStream_t stream);
int nemar_warp_bilinear_bwd(const float* img, const float* xs, const float* ys, const float* g,
                            float* dimg, float* dxs, float* dys, unsigned long long* acc,
                            unsigned int* gmax_bits, int n, int h, int w, int c, int ho, int wo,
                            int gc, cudaStream_t stream);
int nemar_resblock_fwd(const float* x, const float* w1, const float* w2, float* y1, float* y2,
                       float* part, float* stats, float* out, int n, int h, int w, int c, float eps,
                       cudaStream_t stream);
int nemar_resblock_bwd(const float* x, const float* y1, const float* y2, const float* stats,
                       const float* g, const float* w1, const float* w2, float* wsplit, float* dz,
                       float* dpad, float* part_in, float* means, float* part_w, float* dw1,
                       float* dw2, float* dx, int n, int h, int w, int c, int splits,
                       cudaStream_t stream);
int nemar_conv_head_fwd(const float* x, const float* w, float* out, int n, int h, int wd, int ci,
                        int co, cudaStream_t stream);
int nemar_conv_head_bwd(const float* x, const float* w, const float* g, float* part, float* dx,
                        float* dw, int n, int h, int wd, int ci, int co, cudaStream_t stream);
int nemar_convt_in_fwd(const float* x, const float* w, float* yhat, float* part, float* stats,
                       float* out, int n, int h, int w_, int ci, int co, float eps,
                       cudaStream_t stream);
int nemar_convt_in_bwd(const float* x, const float* wt, const float* yhat, const float* stats,
                       const float* g, float* dz, float* part_in, float* means, float* part_w,
                       float* dw, float* dx, int n, int h, int w_, int ci, int co, int splits,
                       int pix_per_split, cudaStream_t stream);
}

namespace {

float* f32(const at::Tensor& t) { return t.data_ptr<float>(); }
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

void warp_bwd(const at::Tensor& img, const at::Tensor& xs, const at::Tensor& ys,
              const at::Tensor& g, const std::optional<at::Tensor>& dimg, const at::Tensor& dxs,
              const at::Tensor& dys, const at::Tensor& acc, const at::Tensor& gmax,
              int64_t grad_channels) {
  const c10::cuda::CUDAGuard guard(img.device());
  check(nemar_warp_bilinear_bwd(
            f32(img), f32(xs), f32(ys), f32(g), dimg ? f32(*dimg) : nullptr, f32(dxs), f32(dys),
            reinterpret_cast<unsigned long long*>(acc.data_ptr<int64_t>()),
            reinterpret_cast<unsigned int*>(gmax.data_ptr<int32_t>()), dim(img, 0), dim(img, 1),
            dim(img, 2), dim(img, 3), dim(xs, 1), dim(xs, 2), static_cast<int>(grad_channels),
            stream()),
        "warp_bwd");
}

void resblock_fwd(const at::Tensor& x, const at::Tensor& w1, const at::Tensor& w2,
                  const at::Tensor& y1, const at::Tensor& y2, const at::Tensor& part,
                  const at::Tensor& stats, const at::Tensor& out, double eps) {
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_resblock_fwd(f32(x), f32(w1), f32(w2), f32(y1), f32(y2), f32(part), f32(stats),
                           f32(out), dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3),
                           static_cast<float>(eps), stream()),
        "resblock_fwd");
}

void resblock_bwd(const at::Tensor& x, const at::Tensor& y1, const at::Tensor& y2,
                  const at::Tensor& stats, const at::Tensor& g, const at::Tensor& w1,
                  const at::Tensor& w2, const at::Tensor& wsplit, const at::Tensor& dz,
                  const at::Tensor& dpad, const at::Tensor& part_in, const at::Tensor& means,
                  const at::Tensor& part_w, const at::Tensor& dw1, const at::Tensor& dw2,
                  const at::Tensor& dx, int64_t splits) {
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_resblock_bwd(f32(x), f32(y1), f32(y2), f32(stats), f32(g), f32(w1), f32(w2),
                           f32(wsplit), f32(dz), f32(dpad), f32(part_in), f32(means), f32(part_w),
                           f32(dw1), f32(dw2), f32(dx), dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3),
                           static_cast<int>(splits), stream()),
        "resblock_bwd");
}

void conv_head_fwd(const at::Tensor& x, const at::Tensor& w, const at::Tensor& out) {
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_conv_head_fwd(f32(x), f32(w), f32(out), dim(x, 0), dim(x, 1), dim(x, 2), dim(x, 3),
                            dim(w, 3), stream()),
        "conv_head_fwd");
}

void conv_head_bwd(const at::Tensor& x, const at::Tensor& w, const at::Tensor& g,
                   const at::Tensor& part, const at::Tensor& dx, const at::Tensor& dw) {
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_conv_head_bwd(f32(x), f32(w), f32(g), f32(part), f32(dx), f32(dw), dim(x, 0),
                            dim(x, 1), dim(x, 2), dim(x, 3), dim(w, 3), stream()),
        "conv_head_bwd");
}

void convt_in_fwd(const at::Tensor& x, const at::Tensor& w, const at::Tensor& yhat,
                  const at::Tensor& part, const at::Tensor& stats, const at::Tensor& out,
                  double eps) {
  const c10::cuda::CUDAGuard guard(x.device());
  check(nemar_convt_in_fwd(f32(x), f32(w), f32(yhat), f32(part), f32(stats), f32(out), dim(x, 0),
                           dim(x, 1), dim(x, 2), dim(x, 3), dim(w, 3), static_cast<float>(eps),
                           stream()),
        "convt_in_fwd");
}

void convt_in_bwd(const at::Tensor& x, const at::Tensor& wt, const at::Tensor& yhat,
                  const at::Tensor& stats, const at::Tensor& g, const at::Tensor& dz,
                  const at::Tensor& part_in, const at::Tensor& means, const at::Tensor& part_w,
                  const at::Tensor& dw, const at::Tensor& dx, int64_t splits,
                  int64_t pix_per_split) {
  const c10::cuda::CUDAGuard guard(x.device());
  // wt is W^T, (3, 3, Co, Ci)
  check(nemar_convt_in_bwd(f32(x), f32(wt), f32(yhat), f32(stats), f32(g), f32(dz), f32(part_in),
                           f32(means), f32(part_w), f32(dw), f32(dx), dim(x, 0), dim(x, 1),
                           dim(x, 2), dim(x, 3), dim(wt, 2), static_cast<int>(splits),
                           static_cast<int>(pix_per_split), stream()),
        "convt_in_bwd");
}

}  // namespace

TORCH_LIBRARY(nemar, m) {
  m.def("warp_grid(Tensor img, Tensor grid, int padding, bool align_corners) -> Tensor",
        &warp_grid);
  m.def("warp_bwd(Tensor img, Tensor xs, Tensor ys, Tensor g, Tensor(a!)? dimg, Tensor(b!) dxs, "
        "Tensor(c!) dys, Tensor(d!) acc, Tensor(e!) gmax, int grad_channels) -> ()",
        &warp_bwd);
  m.def("resblock_fwd(Tensor x, Tensor w1, Tensor w2, Tensor(a!) y1, Tensor(b!) y2, "
        "Tensor(c!) part, Tensor(d!) stats, Tensor(e!) out, float eps) -> ()",
        &resblock_fwd);
  m.def("resblock_bwd(Tensor x, Tensor y1, Tensor y2, Tensor stats, Tensor g, Tensor w1, "
        "Tensor w2, Tensor(a!) wsplit, Tensor(b!) dz, Tensor(c!) dpad, Tensor(d!) part_in, "
        "Tensor(e!) means, Tensor(f!) part_w, Tensor(g!) dw1, Tensor(h!) dw2, Tensor(i!) dx, "
        "int splits) -> ()",
        &resblock_bwd);
  m.def("conv_head_fwd(Tensor x, Tensor w, Tensor(a!) out) -> ()", &conv_head_fwd);
  m.def("conv_head_bwd(Tensor x, Tensor w, Tensor g, Tensor(a!) part, Tensor(b!) dx, "
        "Tensor(c!) dw) -> ()",
        &conv_head_bwd);
  m.def("convt_in_fwd(Tensor x, Tensor w, Tensor(a!) yhat, Tensor(b!) part, Tensor(c!) stats, "
        "Tensor(d!) out, float eps) -> ()",
        &convt_in_fwd);
  m.def("convt_in_bwd(Tensor x, Tensor wt, Tensor yhat, Tensor stats, Tensor g, Tensor(a!) dz, "
        "Tensor(b!) part_in, Tensor(c!) means, Tensor(d!) part_w, Tensor(e!) dw, Tensor(f!) dx, "
        "int splits, int pix_per_split) -> ()",
        &convt_in_bwd);
}
