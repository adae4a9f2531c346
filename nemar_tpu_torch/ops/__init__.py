"""Ops of the port: warp, instance norm + activation, fused ResNet block,
the generator's 7x7 head conv and its fused decoder stage.

Each op dispatches on its input's device: the plain PyTorch version on the
CPU, the hand-written Hopper kernel on CUDA (see each module's docstring).
"""
