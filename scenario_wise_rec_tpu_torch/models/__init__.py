"""Model registry (the JAX package's ``models/__init__.py``).

``MODEL_REGISTRY`` holds every model of the JAX registry, under every
alias it gives them; :func:`get_model` resolves any casing of a name (the
reference scripts spell "sharedbottom" three ways) and raises ``KeyError``
for a name it does not know.
"""

from .adaptdhm import AdaptDHM
from .adasparse import AdaSparse
from .base import Base, Model, domain_ids
from .epnet import EPNet
from .hamur import HamurLarge, HamurSmall, MlpNLayer
from .m2m import M2M
from .m3oe import M3oE
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
    "m2m": M2M,
    "m3oe": M3oE,
    "adaptdhm": AdaptDHM,
    "hamur": HamurLarge,
    "hamurlarge": HamurLarge,
    "hamur_small": HamurSmall,
    "hamursmall": HamurSmall,
    "mlpn": MlpNLayer,
    "base": Base,
}



def get_model(name: str):
    """Resolve a model class from any casing of its name."""
    key = name.lower().replace("-", "")
    for k in (key, key.replace("_", "")):
        if k in MODEL_REGISTRY:
            return MODEL_REGISTRY[k]
    raise KeyError(f"unknown model '{name}' (known: {sorted(MODEL_REGISTRY)})")


__all__ = ["AdaSparse", "AdaptDHM", "Base", "EPNet", "HamurLarge", "HamurSmall", "M2M", "M3oE",
           "MlpNLayer", "Model", "domain_ids", "MMOE", "PLE", "PPNet", "Sarnet", "SharedBottom",
           "Star", "MODEL_REGISTRY", "get_model"]
