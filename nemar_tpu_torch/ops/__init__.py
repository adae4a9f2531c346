"""Ops of the port: warp, instance norm + activation, fused ResNet block.

Each op dispatches on its input's device: the plain PyTorch version on the
CPU, the hand-written Hopper kernel on CUDA (see each module's docstring).
"""
