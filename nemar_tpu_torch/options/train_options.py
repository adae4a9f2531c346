"""Train options: the JAX package's training flags, with this package's
model registry. The flags whose code paths are not ported are parsed and
refused by the model, by name (``--pool_size > 0``, ``--grad_accum > 1``,
``--ema_decay > 0``, ``--gan_mode wgangp``, ``--steps_per_execution > 1``,
``--opt_fused``, ``--opt_split``)."""

from nemar_tpu.options import train_options as _ref
from nemar_tpu_torch.options.base_options import BaseOptions


class TrainOptions(BaseOptions, _ref.TrainOptions):
    pass
