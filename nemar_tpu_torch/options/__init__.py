"""Option parsing (reference ``options/`` package): two-pass argparse with
per-model and per-dataset flag injection."""

from nemar_tpu_torch.options.base_options import BaseOptions
from nemar_tpu_torch.options.test_options import TestOptions
from nemar_tpu_torch.options.train_options import TrainOptions

__all__ = ["BaseOptions", "TestOptions", "TrainOptions"]
