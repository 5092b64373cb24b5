from .base import Base, Model, domain_ids
from .mmoe import MMOE

__all__ = ["Base", "Model", "domain_ids", "MMOE"]
