"""Deterministic synthetic data (the port's own copy, pure numpy)."""
from .pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
