"""Model base class (reference ``models/base_model.py``), PyTorch inside.

Same public surface as the JAX package's BaseModel: setup / train / eval /
test / set_epoch / update_learning_rate / get_current_losses /
get_current_visuals / save_networks / load_networks / print_networks.
Inside:

  * one ``nn.Module`` per net (``self.net<Name>``) on ``self.device``, taken
    from ``--gpu_ids``: none (``-1``) means the CPU, ``k`` means ``cuda:k``
    and raises when CUDA is absent;
  * checkpoints are the reference's per-net state_dict files
    ``{suffix}_net_{Name}.pth`` under ``checkpoints/{name}/``;
  * the model boundary keeps the reference's NHWC numpy layout
    (``set_input`` in, ``get_current_visuals`` out), as the numpy utilities
    of ``nemar_tpu_torch.utils`` and ``nemar_tpu_torch.data`` (copies of the
    JAX package's) expect.

  * for training, ``setup()`` builds one ``torch.optim.Adam`` per net
    (``make_optimizers``); the lr is stepped once per epoch on the host by
    the JAX package's policies (``networks.get_lr_multiplier_fn``) and set
    on every param group, times the group's ``lr_ratio``.

Training on CUDA sets ``torch.backends.cudnn.deterministic``, so two runs
from one state are bit-identical, as the JAX package's are.
``--continue_train`` loads the per-net files; the full training state with
the Adam moments is queued as ROADMAP.md A6.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from collections import OrderedDict

import numpy as np
import torch

from nemar_tpu_torch.models.networks import get_lr_multiplier_fn


def resolve_device(gpu_ids) -> torch.device:
    """``--gpu_ids`` (parsed to a list of ints) -> the device to run on."""
    if not gpu_ids:
        return torch.device("cpu")
    if len(gpu_ids) > 1:
        raise NotImplementedError(
            f"--gpu_ids {gpu_ids}: one device per process for now (queued as ROADMAP.md A10)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids {gpu_ids[0]} asks for CUDA, but torch.cuda.is_available() is False; "
            f"pass --gpu_ids -1 to run on the CPU")
    return torch.device("cuda", gpu_ids[0])


def to_device_nchw(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """NHWC numpy batch -> NCHW fp32 tensor in channels_last memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return t.to(device).permute(0, 3, 1, 2)


def to_numpy_nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC numpy array."""
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


class BaseModel(ABC):
    def __init__(self, opt):
        self.opt = opt
        self.isTrain = opt.isTrain
        self.device = resolve_device(opt.gpu_ids)
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.save_dir, exist_ok=True)
        self.model_names: list[str] = []
        self.loss_names: list[str] = []
        self.optimizers: dict[str, torch.optim.Optimizer] = {}
        self.metric = 0.0  # fed to the plateau policy
        self._losses: dict[str, torch.Tensor] = {}
        self._visuals: dict[str, torch.Tensor] = {}

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    @abstractmethod
    def set_input(self, data: dict):
        ...

    @abstractmethod
    def forward(self):
        ...

    @abstractmethod
    def optimize_parameters(self):
        ...

    def nets(self) -> dict:
        return {n: getattr(self, f"net{n}") for n in self.model_names}

    def make_optimizers(self) -> dict:
        """{net name: optimizer} for training; each param group carries an
        ``lr_ratio`` (its lr is ``current_lr * lr_ratio``)."""
        return {}

    # -- lifecycle ---------------------------------------------------------
    def setup(self, opt):
        """Schedules and optimizers (training), checkpoints (inference or
        --continue_train), print."""
        resume = self.isTrain and getattr(opt, "continue_train", False)
        if self.isTrain:
            self.lr_fn = get_lr_multiplier_fn(opt)
            self.current_lr = opt.lr
            if resume:
                # epoch epoch_count trains at the multiplier of the last
                # completed epoch, as the JAX package resumes
                self.current_lr = opt.lr * self.lr_fn(max(0, opt.epoch_count - 1), None)
        if not self.isTrain or resume:
            suffix = f"iter_{opt.load_iter}" if opt.load_iter > 0 else opt.epoch
            self.load_networks(suffix)
        if self.isTrain:
            self.optimizers = self.make_optimizers()
            self._set_lr()
            self.train()
            if self.device.type == "cuda":
                # bit-identical steps, as the JAX package's: cuDNN's default
                # convolution backward algorithms sum in a run-dependent order
                torch.backends.cudnn.deterministic = True
        self.print_networks(getattr(opt, "verbose", False))

    def train(self):
        for net in self.nets().values():
            net.train()

    def eval(self):
        for net in self.nets().values():
            net.eval()

    def test(self):
        """Inference forward, without autograd."""
        with torch.no_grad():
            self.forward()

    # -- losses, epoch-indexed schedules, lr -----------------------------------
    def get_current_losses(self) -> "OrderedDict[str, float]":
        """The last step's losses as floats, in ``loss_names`` order (one
        device sync)."""
        return OrderedDict((k, float(self._losses[k])) for k in self.loss_names
                           if k in self._losses)

    def set_epoch(self, epoch: int):
        """Current absolute epoch (the train loop calls this at epoch start;
        it feeds the warm-up and ramp schedules)."""
        self._cur_epoch = int(epoch)

    def _set_lr(self):
        for optimizer in self.optimizers.values():
            for group in optimizer.param_groups:
                group["lr"] = self.current_lr * group.get("lr_ratio", 1.0)

    def update_learning_rate(self, epoch: int | None = None):
        """Step the per-epoch lr multiplier (reference update_learning_rate);
        the plateau policy is fed the last step's G loss, as in the JAX
        package."""
        if epoch is None:
            epoch = getattr(self, "_epoch", self.opt.epoch_count)
            self._epoch = epoch + 1
        if getattr(self.opt, "lr_policy", "linear") == "plateau" and self._losses:
            key = "G" if "G" in self._losses else sorted(self._losses)[0]
            self.metric = float(self._losses[key])
        old = self.current_lr
        self.current_lr = self.opt.lr * self.lr_fn(epoch, self.metric)
        self._set_lr()
        print(f"learning rate {old:.7f} -> {self.current_lr:.7f}")

    # -- visuals -------------------------------------------------------------
    def get_current_visuals(self) -> "OrderedDict[str, np.ndarray]":
        """NHWC numpy arrays, the JAX package's layout."""
        return OrderedDict((k, to_numpy_nhwc(v)) for k, v in self._visuals.items()
                           if v is not None)

    def get_image_paths(self):
        return getattr(self, "image_paths", [])

    # -- checkpoints -------------------------------------------------------
    def _net_path(self, suffix, name: str) -> str:
        return os.path.join(self.save_dir, f"{suffix}_net_{name}.pth")

    def save_networks(self, suffix):
        for name, net in self.nets().items():
            state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
            torch.save(state, self._net_path(suffix, name))

    def load_networks(self, suffix):
        """Load every net; a missing file raises (never run random weights)."""
        for name, net in self.nets().items():
            path = self._net_path(suffix, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no checkpoint for net {name} at {path} — refusing to run "
                    f"inference with randomly initialized weights")
            print(f"loading the model from {path}")
            net.load_state_dict(torch.load(path, map_location=self.device, weights_only=True))

    def print_networks(self, verbose: bool):
        print("---------- Networks initialized -------------")
        for name, net in self.nets().items():
            n = sum(p.numel() for p in net.parameters())
            print(f"[Network {name}] Total number of parameters : {n / 1e6:.3f} M")
            if verbose:
                print(net)
        print("-----------------------------------------------")
