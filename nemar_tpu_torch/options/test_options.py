"""Test options: the JAX package's test flags and invariants (batch 1,
ordered, no flip), with this package's model registry."""

from nemar_tpu.options import test_options as _ref
from nemar_tpu_torch.options.base_options import BaseOptions


class TestOptions(BaseOptions, _ref.TestOptions):
    pass
