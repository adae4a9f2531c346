"""Base options: the JAX package's flags, resolved against this package.

The flag surface (names, defaults, help) is ``nemar_tpu.options``'s, reused
as it is: those modules are plain argparse and import no JAX. Only the
second pass changes, which injects the chosen model's flags: it resolves
``--model`` in ``nemar_tpu_torch.models``. Datasets come from
``nemar_tpu.data`` (numpy and PIL).

In this package ``--gpu_ids`` picks the device (``-1``: the CPU; ``k``:
``cuda:k``); the TPU-only flags (``--num_devices``, ``--bf16``,
``--warp_impl``, ``--norm_impl``, ...) are parsed and, where they would
change the computation, refused by the model.
"""

from __future__ import annotations

import argparse

from nemar_tpu.options import base_options as _ref


class BaseOptions(_ref.BaseOptions):
    def gather_options(self, args=None):
        """Two-pass parse with model/dataset flag injection (this package's
        model registry)."""
        parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser = self.initialize(parser)
        opt, _ = parser.parse_known_args(args)

        from nemar_tpu_torch import models as models_pkg

        parser = models_pkg.get_option_setter(opt.model)(parser, self.isTrain)
        opt, _ = parser.parse_known_args(args)

        from nemar_tpu import data as data_pkg

        parser = data_pkg.get_option_setter(opt.dataset_mode)(parser, self.isTrain)
        self.parser = parser
        return parser.parse_args(args)
