"""Model registry (reference ``models/__init__.py``).

``--model nemar`` resolves ``models/nemar_model.py`` class ``NEMARModel`` by
the reference's naming convention; models add their flags through
``modify_commandline_options``. The JAX package's four models are here:
``nemar``, ``pix2pix``, ``cycle_gan`` and ``test``.
"""

from __future__ import annotations

import importlib

from nemar_tpu_torch.models.base_model import BaseModel


def find_model_using_name(model_name: str):
    model_filename = f"nemar_tpu_torch.models.{model_name}_model"
    try:
        modellib = importlib.import_module(model_filename)
    except ModuleNotFoundError as e:
        if e.name != model_filename:
            raise
        raise NotImplementedError(f"model [{model_name}] is not recognized") from None
    target_name = model_name.replace("_", "") + "model"
    for name, cls in modellib.__dict__.items():
        if name.lower() == target_name and isinstance(cls, type) and issubclass(cls, BaseModel):
            return cls
    raise NotImplementedError(
        f"In {model_filename}.py there should be a subclass of BaseModel "
        f"with class name that matches {target_name} in lowercase."
    )


def get_option_setter(model_name: str):
    return find_model_using_name(model_name).modify_commandline_options


def create_model(opt):
    model_class = find_model_using_name(opt.model)
    instance = model_class(opt)
    print(f"model [{type(instance).__name__}] was created")
    return instance
