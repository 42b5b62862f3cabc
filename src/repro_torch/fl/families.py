"""Model-family registry — adapters that build a ``ModelConfig`` for one
``ScenarioConfig`` and declare the task kind they play.  The port carries
the paper CNN; the LM families arrive with their models and kernels."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type

from repro_torch.configs import ModelConfig, get_config


class ModelFamily:
    """Base class for family adapters.  Subclass, implement ``build``, and
    register with ``@register_model_family(name, *aliases)``."""

    name: str = ""
    task: str = "generation"            # task kind this family plays
    default_lr: Optional[float] = None  # None -> the task's default
    default_batch: Optional[int] = None

    def build(self, cfg) -> ModelConfig:
        raise NotImplementedError


FAMILIES: Dict[str, Type[ModelFamily]] = {}


def register_model_family(*names: str):
    """Class decorator registering a ``ModelFamily`` under ``names``."""
    if not names:
        raise ValueError("register_model_family needs at least one name")

    def deco(cls: Type[ModelFamily]) -> Type[ModelFamily]:
        cls.name = names[0]
        for n in names:
            FAMILIES[n] = cls
        return cls
    return deco


def get_model_family(name: str) -> ModelFamily:
    try:
        return FAMILIES[name]()
    except KeyError:
        raise ValueError(f"unknown model family {name!r}; registered: "
                         f"{sorted(FAMILIES)}") from None


@register_model_family("cnn")
class CNNFamily(ModelFamily):
    """The paper's conv classifier at the reference's scenario scale
    (``repro.fl.families.CNNFamily``: channels 8/16, fc 48).  The full
    paper width is ``get_config("cnn-paper")`` itself."""

    task = "classification"

    def build(self, cfg) -> ModelConfig:
        return dataclasses.replace(get_config("cnn-paper"),
                                   image_size=cfg.image_size, d_model=48,
                                   cnn_channels=(8, 16))
