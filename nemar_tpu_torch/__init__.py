"""nemar_tpu_torch — NeMAR registration in PyTorch, with hand-written CUDA
and Triton kernels for NVIDIA Hopper (sm_90a).

The second package beside ``nemar_tpu`` (the JAX reference, which it is
held against in ``tests/test_torch_*.py``). It mirrors the reference's file
names so each module's counterpart is easy to find:

  * ``ops/warp.py`` + ``ops/warp_cuda.py`` + ``csrc/warp_fwd.cu`` — grid
    sampling; the bilinear gather is the CUDA kernel K-warp.
  * ``ops/norm.py`` + ``ops/norm_triton.py`` — instance norm + activation;
    the Triton kernel K-in.
  * ``ops/conv_fused.py`` + ``csrc/resblock_fwd.cu`` — the ResNet trunk
    block; the CUDA kernel K-block.
  * ``models/`` — ResnetGenerator, NLayerDiscriminator, UnetSTN, NEMARModel.
  * ``test.py`` — the inference entry point (``python -m nemar_tpu_torch.test``).

Every kernel op dispatches on the device of its input: a CPU tensor takes
the op's plain PyTorch version, a CUDA tensor launches the kernel or raises.
The package never imports JAX. Model boundaries keep the reference's NHWC
numpy layout; inside, activations are NCHW tensors in ``channels_last``
memory, so the kernels see NHWC-contiguous data.

This slice runs inference; training is queued in ROADMAP.md (A5).
"""

__version__ = "0.1.0"
