"""Train options: the JAX package's training flags, with this package's
model registry. (The training step itself is queued as ROADMAP.md A5.)"""

from nemar_tpu.options import train_options as _ref
from nemar_tpu_torch.options.base_options import BaseOptions


class TrainOptions(BaseOptions, _ref.TrainOptions):
    pass
