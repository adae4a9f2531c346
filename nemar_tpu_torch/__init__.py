"""nemar_tpu_torch — NeMAR registration in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The second package beside ``nemar_tpu`` (the JAX reference, which it is
held against in ``tests/test_torch_*.py``). It mirrors the reference's file
names so each module's counterpart is easy to find:

  * ``ops/warp.py`` + ``ops/warp_cuda.py`` + ``csrc/warp_{fwd,bwd}.cu`` —
    grid sampling; the bilinear gather and its VJP are the CUDA kernels
    K-warp and K-warp-bwd.
  * ``ops/norm.py`` + ``ops/norm_cuda.py`` + ``csrc/in_act_{fwd,bwd}.cu`` —
    instance norm + activation; the CUDA kernels K-in and K-in-bwd, one
    cooperative launch each.
  * ``ops/conv_fused.py`` + ``csrc/resblock_{fwd,bwd}.cu`` — the ResNet
    trunk block; the CUDA kernels K-block and K-block-bwd, on the 3xTF32
    tensor-core GEMM core ``csrc/gemm_tc.cuh``.
  * ``ops/conv_head.py`` + ``csrc/head_{fwd,bwd}.cu`` — the generator's 7x7
    head conv; the CUDA kernels K-head and K-head-bwd.
  * ``ops/convt_fused.py`` + ``csrc/convt_{fwd,bwd}.cu`` — a decoder stage
    (ConvTranspose + IN + ReLU); the CUDA kernels K-convt and K-convt-bwd,
    on the same GEMM core.
  * ``models/`` — ResnetGenerator, UnetGenerator, NLayerDiscriminator,
    PixelDiscriminator, the STNs, and the four models: NEMARModel,
    Pix2PixModel, CycleGANModel and TestModel (inference and the training
    step).
  * ``options/``, ``data/``, ``utils/`` — this package's copies of the JAX
    package's framework-free modules (flags, datasets and loaders, HTML and
    metrics), so that it imports nothing of ``nemar_tpu``.
  * ``test.py``, ``train.py`` — the entry points (``python -m
    nemar_tpu_torch.test`` / ``.train``).

Every kernel op is a ``torch.autograd.Function`` that dispatches on the
device of its input: a CPU tensor takes the op's plain PyTorch versions, a
CUDA tensor launches the kernels or raises. The package never imports JAX
or the JAX package.
Model boundaries keep the reference's NHWC numpy layout; inside,
activations are NCHW tensors in ``channels_last`` memory, so the kernels see
NHWC-contiguous data.

The flags of the JAX package that are not ported yet are refused by name,
each naming its ROADMAP.md item.
"""

__version__ = "0.1.0"
