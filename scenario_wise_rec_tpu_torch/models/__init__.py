"""Model registry (the JAX package's ``models/__init__.py``).

``MODEL_REGISTRY`` holds the models the port has, under every alias the
JAX registry gives them; :func:`get_model` resolves any casing of a name
(the reference scripts spell "sharedbottom" three ways). A name the JAX
registry knows that the port does not have yet raises
``NotImplementedError`` naming its ROADMAP item, not ``KeyError``.
"""

from .adaptdhm import AdaptDHM
from .adasparse import AdaSparse
from .base import Base, Model, domain_ids
from .epnet import EPNet
from .hamur import HamurLarge, HamurSmall, MlpNLayer
from .mmoe import MMOE
from .ple import PLE
from .ppnet import PPNet
from .sarnet import Sarnet
from .sharedbottom import SharedBottom
from .star import Star

MODEL_REGISTRY = {
    "sharedbottom": SharedBottom,
    "sharebottom": SharedBottom,
    "mmoe": MMOE,
    "ple": PLE,
    "star": Star,
    "sarnet": Sarnet,
    "epnet": EPNet,
    "ppnet": PPNet,
    "adasparse": AdaSparse,
    "adaptdhm": AdaptDHM,
    "hamur": HamurLarge,
    "hamurlarge": HamurLarge,
    "hamur_small": HamurSmall,
    "hamursmall": HamurSmall,
    "mlpn": MlpNLayer,
    "base": Base,
}

# the JAX registry's other names, each with the ROADMAP item that ports it
NOT_PORTED = {name: "A11" for name in ("m2m", "m3oe")}


def get_model(name: str):
    """Resolve a model class from any casing of its name."""
    key = name.lower().replace("-", "")
    for k in (key, key.replace("_", "")):
        if k in MODEL_REGISTRY:
            return MODEL_REGISTRY[k]
        if k in NOT_PORTED:
            raise NotImplementedError(
                f"model '{name}' is not ported yet (ROADMAP {NOT_PORTED[k]}; "
                f"the port has {sorted(MODEL_REGISTRY)})")
    raise KeyError(f"unknown model '{name}' (known: "
                   f"{sorted(MODEL_REGISTRY) + sorted(NOT_PORTED)})")


__all__ = ["AdaSparse", "AdaptDHM", "Base", "EPNet", "HamurLarge", "HamurSmall", "MlpNLayer",
           "Model", "domain_ids", "MMOE", "PLE", "PPNet", "Sarnet", "SharedBottom", "Star",
           "MODEL_REGISTRY", "NOT_PORTED", "get_model"]
