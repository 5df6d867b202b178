"""Approximate Random Dropout core: patterns, Alg. 1 search, the plan."""
from . import dropout, patterns, plan, search
from .plan import (BACKENDS, FAMILIES, IDENTITY, BoundPlan, DropoutPlan,
                   LayerOverride, as_bound, build_plan, get_family,
                   identity_plan)
from .search import SearchConfig, resume_search, search_distribution

__all__ = [
    "dropout", "patterns", "plan", "search",
    "BACKENDS", "FAMILIES", "IDENTITY", "BoundPlan", "DropoutPlan",
    "LayerOverride", "as_bound", "build_plan", "get_family", "identity_plan",
    "SearchConfig", "resume_search", "search_distribution",
]
