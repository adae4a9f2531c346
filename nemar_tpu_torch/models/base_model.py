"""Model base class (reference ``models/base_model.py``), PyTorch inside.

Same public surface as the JAX package's BaseModel: setup / train / eval /
test / set_epoch / update_learning_rate / get_current_losses /
get_current_visuals / save_networks / load_networks / print_networks.
Inside:

  * one ``nn.Module`` per net (``self.net<Name>``) on ``self.device``, taken
    from ``--gpu_ids``: none (``-1``) means the CPU, ``k`` means ``cuda:k``
    and raises when CUDA is absent; in a rank of a data-parallel run
    (``nemar_tpu_torch.parallel``) the rank's device;
  * in a data-parallel run every rank builds the same model from the same
    seed and takes its rows of the global batch (``set_input``), and under
    --mesh_spatial its band of their rows (``band_of``); the reported
    losses are the global batch's (``get_current_losses``), and rank 0
    alone writes checkpoints;
  * checkpoints are the reference's per-net state_dict files
    ``{suffix}_net_{Name}.pth`` under ``checkpoints/{name}/``; a training
    model also writes the full training state ``{suffix}_state.pth`` and
    ``checkpoint_meta.json`` (see ``save_networks``);
  * the model boundary keeps the reference's NHWC numpy layout
    (``set_input`` in, ``get_current_visuals`` out), as the numpy utilities
    of ``nemar_tpu_torch.utils`` and ``nemar_tpu_torch.data`` (copies of the
    JAX package's) expect.

  * for training, ``setup()`` builds one ``torch.optim.Adam`` per net
    (``make_optimizers``); the lr is stepped once per epoch on the host by
    the JAX package's policies (``networks.get_lr_multiplier_fn``).
    ``current_lr`` is a property: assigning it (the policy's step, a
    resume, or a caller such as the science recipe's refinement phase)
    sets every param group's lr to it times the group's ``lr_ratio``, so
    the next step runs at it, as the JAX package's step reads
    ``current_lr`` at every call.

``--bf16`` is the JAX package's bfloat16 compute with fp32 parameters
(``nemar_tpu/models/nemar_model.py:_cast``): the parameters, their
gradients, the optimizers' state (and the NeMAR model's EMA shadows and
image pool) stay fp32; a forward runs a net through ``compute(net)``, a
call of the net on bf16 copies of its parameters made by differentiable
casts, so every gradient reaches its fp32 parameter in fp32. A forward
without autograd (``test``) reuses one set of copies until a parameter
changes.

Training on CUDA sets ``torch.backends.cudnn.deterministic``, so two runs
from one state are bit-identical, as the JAX package's are.
``--continue_train`` restores the full training state (the nets, every
Adam's moments and step, the step count, the plateau controller, and the
NeMAR model's EMA shadows, image pool and step generator), so a
resumed run continues bit for bit as an uninterrupted one, as the JAX
package's does (``nemar_tpu/models/base_model.py``: ``save_networks``,
``load_networks``).
"""

from __future__ import annotations

import atexit
import glob
import hashlib
import json
import os
import threading
import weakref
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from nemar_tpu_torch import parallel
from nemar_tpu_torch.models.networks import get_lr_multiplier_fn
from nemar_tpu_torch.parallel import spatial


def resolve_device(gpu_ids) -> torch.device:
    """``--gpu_ids`` (parsed to a list of ints) -> this process's device:
    the CPU for none; in a rank of a data-parallel run the device its
    launch gave it (``cuda:gpu_ids[rank]``); else ``cuda:gpu_ids[0]`` (a
    one-process run, such as test.py's, serves on the first id). Ids
    without CUDA raise: there is no CPU fallback."""
    if not gpu_ids:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids {','.join(map(str, gpu_ids))} asks for CUDA, but "
            f"torch.cuda.is_available() is False; pass --gpu_ids -1 to run on the CPU")
    dev = parallel.device()
    if dev is not None and dev.type == "cuda":
        return dev
    return torch.device("cuda", gpu_ids[0])


def to_device_nchw(arr: np.ndarray, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC numpy batch -> NCHW tensor (fp32 unless ``dtype`` says) in
    channels_last memory."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return t.to(device, dtype).permute(0, 3, 1, 2)


def to_numpy_nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC numpy array."""
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


def dropout_seed(seed: int, step: int) -> int:
    """The seed of training step ``step``'s dropout draws (the model
    reseeds its dropout generator with it before each step): a function of
    --seed and the step count alone, which ``{suffix}_state.pth`` carries,
    so a resumed run draws the masks an uninterrupted one draws, on either
    device type, as the JAX package's key, carried in its state, continues
    on any device. (A CUDA generator's state does not fit a CPU one's, and
    a CPU generator keeps 32 bits of a seed.) Step 0 draws from ``seed``;
    the multiplier is odd, so 2^32 steps in a row take distinct seeds."""
    return (seed + step * 0x9E3779B1) % 2**32


def state_digest(model) -> str:
    """A SHA-256 over the model's parameters and its optimizers' state, in
    a fixed order: equal digests mean bit-identical training states (the
    ranks of a data-parallel run are held to this)."""
    h = hashlib.sha256()

    def add(t) -> None:
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous()
            h.update(str((t.dtype, tuple(t.shape))).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(t).encode())

    for name, net in model.nets().items():
        for key, p in net.named_parameters():
            h.update(f"{name}.{key}".encode())
            add(p)
    for name, optimizer in model.optimizers.items():
        for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"]):
            for key, v in sorted(optimizer.state.get(p, {}).items()):
                h.update(f"{name}.{i}.{key}".encode())
                add(v)
    return h.hexdigest()


def to_host(obj):
    """``obj`` (tensors in dicts, lists and tuples) with every tensor copied
    to the host: a snapshot that later in-place writes do not reach."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def write_checkpoint(files: dict) -> None:
    """torch.save each {path: object}, each under a temporary name renamed
    into place, so a file is whole or absent."""
    for path, obj in files.items():
        torch.save(obj, path + ".tmp")
        os.replace(path + ".tmp", path)


def _flush_at_exit(ref) -> None:
    model = ref()
    if model is not None:
        model._flush_pending_meta()


class BaseModel(ABC):
    # whether the model runs under --mesh_spatial > 1 (its nets in bands)
    spatial = False

    def __init__(self, opt):
        self.opt = opt
        self.isTrain = opt.isTrain
        self.device = resolve_device(opt.gpu_ids)
        self.dtype = torch.float32  # of the parameters and inputs (``to_dtype``)
        # --bf16: the forward computes in bf16 (the parameters stay fp32)
        self.bf16 = getattr(opt, "bf16", False)
        # {net: ((id, version) of each parameter, its bf16 copies)}
        self._bf16_copies: dict = {}
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.save_dir, exist_ok=True)
        self.model_names: list[str] = []
        self.loss_names: list[str] = []
        self.optimizers: dict[str, torch.optim.Optimizer] = {}
        self.step = 0  # training steps taken (optimize_parameters)
        self.metric = 0.0  # fed to the plateau policy
        self._losses: dict[str, torch.Tensor] = {}
        self._visuals: dict[str, torch.Tensor] = {}
        if getattr(opt, "mesh_spatial", 1) > 1 and not self.spatial:
            raise NotImplementedError(
                f"--model {getattr(opt, 'model', type(self).__name__)} under --mesh_spatial "
                f"{opt.mesh_spatial}: the model has no band form")
        if getattr(opt, "steps_per_execution", 1) > 1 and not hasattr(
                self, "optimize_parameters_scan"):
            raise NotImplementedError(
                f"--steps_per_execution > 1: the JAX package has no fused step for the "
                f"{getattr(opt, 'model', type(self).__name__)} model (only nemar's "
                f"optimize_parameters_scan)")

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    @abstractmethod
    def set_input(self, data: dict):
        """A batch from the loader: the global batch, or over several hosts
        under --loader grain its host's rows of it
        (``parallel.global_rows`` gives the global count); the model keeps
        this rank's rows (``parallel.shard_rows``)."""

    @abstractmethod
    def forward(self):
        ...

    @abstractmethod
    def optimize_parameters(self):
        ...

    def nets(self) -> dict:
        return {n: getattr(self, f"net{n}") for n in self.model_names}

    def band_of(self, height: int):
        """This rank's band of a frame of ``height`` rows under
        --mesh_spatial (``spatial.Band.split``; None: no spatial group)."""
        s = parallel.spatial_size()
        return None if s == 1 else spatial.Band.split(height, s, parallel.spatial_rank())

    def to_dtype(self, dtype: torch.dtype) -> None:
        """Run the model in ``dtype`` (torch.float64 for the CPU tests
        against the JAX package): the nets, and the inputs ``set_input``
        makes; before ``setup``, which makes the optimizers and shadows
        from the parameters."""
        self.dtype = dtype
        for net in self.nets().values():
            net.to(dtype)

    def compute(self, net: torch.nn.Module) -> Callable:
        """``net`` as the forward runs it: under --bf16 a call of net on bf16
        copies of its fp32 parameters (``torch.func.functional_call``; the
        casts are differentiable, so each gradient reaches its parameter in
        fp32), else net itself. Without autograd the copies are made once
        and kept while no parameter changes (each parameter's in-place
        version counter, moved by an optimizer step or a load)."""
        if not self.bf16:
            return net
        if torch.is_grad_enabled():
            params = {k: p.to(torch.bfloat16) for k, p in net.named_parameters()}
        else:
            named = list(net.named_parameters())
            key = tuple((id(p), p._version) for _, p in named)
            kept = self._bf16_copies.get(net)
            if kept is None or kept[0] != key:
                kept = key, {k: p.to(torch.bfloat16) for k, p in named}
                self._bf16_copies[net] = kept
            params = kept[1]
        return lambda *args, **kwargs: torch.func.functional_call(net, params, args, kwargs)

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """x in bf16 under --bf16 (differentiably), else x itself."""
        return x.to(torch.bfloat16) if self.bf16 else x

    def uncast(self, x: torch.Tensor) -> torch.Tensor:
        """x back in fp32 under --bf16 (differentiably), else x itself."""
        return x.float() if self.bf16 else x

    def make_optimizers(self) -> dict:
        """{net name: optimizer} for training; each param group carries an
        ``lr_ratio`` (its lr is ``current_lr * lr_ratio``)."""
        return {}

    def adam(self, params, beta1: float, lr_ratio: float = 1.0) -> torch.optim.Adam:
        """Adam, ``betas=(beta1, 0.999), eps=1e-8``: optax ``scale_by_adam``
        with the lr applied outside, as the JAX package's
        ``models/optim.py``; the lr is ``current_lr * lr_ratio``. On the
        card under --steps_per_execution > 1 it is ``capturable`` (its step
        counts on the device, for a CUDA graph of the step) and its lr a
        device scalar that ``current_lr`` fills in place, so a captured
        step reads the lr of its replay; elsewhere plain Adam, so the
        step-by-step path keeps its numbers.

        --opt_fused and --opt_split are the JAX package's flat-bucket Adam
        (``nemar_tpu/models/optim.py``: the same elementwise math, a layout
        of a few flat vectors): here torch's multi-tensor Adam,
        ``foreach=True``, each of its operations applied to the whole list
        of a net's parameters at once. ``foreach`` and not ``fused``: the
        foreach path does the per-tensor path's operations in the same
        order, so the step keeps its bits (on the card it is already
        PyTorch's default for CUDA parameters), and it takes a CUDA graph's
        capturable state; ``fused=True`` is one kernel with its own
        arithmetic order, and would change the numbers."""
        lr = self.current_lr * lr_ratio
        foreach = (True if getattr(self.opt, "opt_fused", False)
                   or getattr(self.opt, "opt_split", False) else None)
        if self.device.type == "cuda" and getattr(self.opt, "steps_per_execution", 1) > 1:
            return torch.optim.Adam([{"params": list(params), "lr_ratio": lr_ratio}],
                                    lr=torch.tensor(lr, device=self.device),
                                    betas=(beta1, 0.999), eps=1e-8, capturable=True,
                                    foreach=foreach)
        return torch.optim.Adam([{"params": list(params), "lr_ratio": lr_ratio}],
                                lr=lr, betas=(beta1, 0.999), eps=1e-8, foreach=foreach)

    # -- lifecycle ---------------------------------------------------------
    def setup(self, opt):
        """Schedules and optimizers (training), checkpoints (inference: the
        nets; --continue_train: the training state), print. --auto_resume
        turns --continue_train on when ``checkpoint_meta.json`` exists, as
        the JAX package's setup does (a preempted run restarted with it
        continues, and does not write over its checkpoints from scratch)."""
        suffix = f"iter_{opt.load_iter}" if opt.load_iter > 0 else opt.epoch
        if not self.isTrain:
            self.load_networks(suffix)
        else:
            self.lr_fn = get_lr_multiplier_fn(opt)
            self.current_lr = opt.lr
            self.optimizers = self.make_optimizers()
            if getattr(opt, "auto_resume", False) and not getattr(opt, "continue_train", False):
                if os.path.exists(self._meta_path()):
                    print("auto-resume: found a checkpoint, continuing training")
                    opt.continue_train = True
                else:
                    print(f"auto-resume: no checkpoint in {self.save_dir}; starting fresh")
            if getattr(opt, "continue_train", False):
                # epoch epoch_count trains at the multiplier of the last
                # completed epoch, as the JAX package resumes
                self.current_lr = opt.lr * self.lr_fn(max(0, opt.epoch_count - 1), None)
                self.load_train_state(suffix)
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
        device sync); in a data-parallel run the means over the ranks, the
        global batch's (every rank calls it)."""
        names = [k for k in self.loss_names if k in self._losses]
        means = parallel.mean_over_ranks({k: self._losses[k] for k in names})
        return OrderedDict((k, means[k]) for k in names)

    def set_epoch(self, epoch: int):
        """Current absolute epoch (the train loop calls this at epoch start;
        it feeds the warm-up and ramp schedules)."""
        self._cur_epoch = int(epoch)

    @property
    def current_lr(self) -> float:
        return self._current_lr

    @current_lr.setter
    def current_lr(self, lr: float):
        """The lr of the next step: every param group's is ``lr`` times its
        ``lr_ratio``."""
        self._current_lr = lr
        for optimizer in self.optimizers.values():
            for group in optimizer.param_groups:
                value = lr * group.get("lr_ratio", 1.0)
                if isinstance(group["lr"], torch.Tensor):
                    group["lr"].fill_(value)
                else:
                    group["lr"] = value

    def update_learning_rate(self, epoch: int | None = None):
        """Step the per-epoch lr multiplier (reference update_learning_rate);
        the plateau policy is fed the last step's G loss, as in the JAX
        package."""
        if epoch is None:
            epoch = getattr(self, "_epoch", self.opt.epoch_count)
            self._epoch = epoch + 1
        if getattr(self.opt, "lr_policy", "linear") == "plateau" and self._losses:
            key = "G" if "G" in self._losses else sorted(self._losses)[0]
            # the global batch's loss, so every rank's controller steps alike
            self.metric = self.get_current_losses()[key]
        old = self.current_lr
        self.current_lr = self.opt.lr * self.lr_fn(epoch, self.metric)
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

    def _state_path(self, suffix) -> str:
        return os.path.join(self.save_dir, f"{suffix}_state.pth")

    def _meta_path(self) -> str:
        return os.path.join(self.save_dir, "checkpoint_meta.json")

    def shadow_states(self) -> dict:
        """{pseudo-net name: state_dict} saved beside the nets (the NeMAR
        model's EMA shadows)."""
        return {}

    def extra_train_state(self) -> dict:
        """What ``{suffix}_state.pth`` holds beyond the optimizers, the step
        count and current_lr, as CPU tensors (the NeMAR model's generator
        state and pool)."""
        return {}

    def load_extra_train_state(self, state: dict, suffix) -> None:
        """Restore ``extra_train_state`` (and the shadows of ``suffix``)."""

    def save_networks(self, suffix):
        """Write ``{suffix}_net_{Name}.pth`` per net and per pseudo-net of
        ``shadow_states``. A training model then writes ``{suffix}_state.pth``
        (every optimizer's state_dict, the step count, current_lr and
        ``extra_train_state``: the state of the generator the step draws
        from, and the image pool's buffer and count), and last
        ``checkpoint_meta.json`` in the JAX package's keys: ``latest``,
        ``step`` and ``lr_state`` = {current_lr, plateau}. Each file is
        written under a temporary name renamed into place, so a file is
        always whole. As in the JAX package, the meta is written at epoch
        end before ``update_learning_rate`` feeds the plateau controller
        that epoch's metric: a resumed plateau run replays one fewer
        observation (the JAX package's accepted one-epoch lag).

        Under --async_checkpoint the save first joins the previous one and
        publishes its meta (``_flush_pending_meta``); it then takes host
        copies of everything it writes, so that no later step, nor a CUDA
        graph's replay writing in place, reaches them; writes the files on
        a background thread and returns. Its meta is published by the next
        save, at the end of ``train.main`` or at exit: ``checkpoint_meta.json``
        names only a save whose files are all in place, so --auto_resume
        never lands on a half-written checkpoint. In a data-parallel run
        rank 0 alone writes."""
        if parallel.rank() != 0:
            # in a data-parallel run rank 0 writes for all: their training
            # states are bit-identical (every rank loads)
            return
        is_async = getattr(self.opt, "async_checkpoint", False)
        if is_async:
            self._flush_pending_meta()
        files = {}
        nets = {n: net.state_dict() for n, net in self.nets().items()}
        for name, state in {**nets, **self.shadow_states()}.items():
            files[self._net_path(suffix, name)] = to_host(dict(state))
        meta = None
        if self.isTrain:
            files[self._state_path(suffix)] = to_host(
                {"optimizers": {n: o.state_dict() for n, o in self.optimizers.items()},
                 "step": self.step, "current_lr": self.current_lr, **self.extra_train_state()})
            meta = {"latest": str(suffix), "step": self.step,
                    "lr_state": {"current_lr": float(self.current_lr),
                                 "plateau": getattr(self.lr_fn, "state", None)}}
        if not is_async:
            write_checkpoint(files)
            if meta is not None:
                self._write_meta(meta)
            return
        self._pending_meta = meta
        self._save_error = None

        def write():
            try:
                write_checkpoint(files)
            except BaseException as e:  # raised by the join
                self._save_error = e

        self._save_thread = threading.Thread(target=write, name="async_checkpoint")
        self._save_thread.start()
        if not getattr(self, "_atexit_registered", False):
            atexit.register(_flush_at_exit, weakref.ref(self))
            self._atexit_registered = True

    def _write_meta(self, meta: dict) -> None:
        with open(self._meta_path() + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(self._meta_path() + ".tmp", self._meta_path())

    def _flush_pending_meta(self) -> None:
        """Join the in-flight --async_checkpoint save, then publish its meta
        (the JAX package's ``_flush_pending_meta``); a no-op when nothing is
        in flight. A save that failed raises here, and its meta is not
        published."""
        thread = getattr(self, "_save_thread", None)
        if thread is None:
            return
        thread.join()
        self._save_thread = None
        meta, self._pending_meta = self._pending_meta, None
        if self._save_error is not None:
            raise RuntimeError("the asynchronous checkpoint save failed") from self._save_error
        if meta is not None:
            self._write_meta(meta)

    def load_train_state(self, suffix):
        """--continue_train: the nets, the optimizers' state, the step
        count and ``extra_train_state`` of ``{suffix}_state.pth`` and its
        shadows (``latest`` resolves through the
        meta), or of the newest ``*_state.pth`` when that one is missing;
        with none at all, training starts fresh. Then the plateau controller
        from the meta, and current_lr re-derived from it and --epoch_count
        (a resume may jump --epoch_count)."""
        meta = {}
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                meta = json.load(f)
        suffix = str(suffix)
        if suffix == "latest" and "latest" in meta:
            suffix = str(meta["latest"])
        path = self._state_path(suffix)
        if not os.path.exists(path):
            # the aliased checkpoint may have been lost to a preemption
            cands = sorted(glob.glob(self._state_path("*")), key=os.path.getmtime)
            if not cands:
                print(f"no checkpoint found at {path}; starting fresh")
                return
            path = cands[-1]
            suffix = os.path.basename(path)[:-len("_state.pth")]
            print(f"checkpoint '{suffix}' missing; falling back to {path}")
        self.load_networks(suffix)
        print(f"loading the training state from {path}")
        # Adam keeps its step counts on the CPU (on the device when
        # capturable); its moments follow the params. A state saved under
        # the other ``capturable`` setting loads under this run's: the
        # saved groups' setting and lr give way to this optimizer's
        state = torch.load(path, map_location="cpu", weights_only=True)
        for name, optimizer in self.optimizers.items():
            saved = state["optimizers"][name]
            for group, saved_group in zip(optimizer.param_groups, saved["param_groups"]):
                saved_group["capturable"] = group["capturable"]
                saved_group["lr"] = group["lr"]
            optimizer.load_state_dict(saved)
        self.step = int(state["step"])
        self.load_extra_train_state(state, suffix)
        plateau = (meta.get("lr_state") or {}).get("plateau")
        if plateau and getattr(self.lr_fn, "state", None) is not None:
            self.lr_fn.state.update(plateau)
        self.current_lr = self.opt.lr * self.lr_fn(max(0, self.opt.epoch_count - 1), None)

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
