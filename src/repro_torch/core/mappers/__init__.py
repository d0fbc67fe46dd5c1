"""Mapping-space-exploration baselines + GOMA behind one interface."""
from .base import Mapper, MapperResult, hw_default_residency
from .cosa_like import CosaLikeMapper
from .factorflow import FactorFlowMapper
from .goma import GomaEqMapper, GomaMapper
from .loma import LomaMapper
from .random_search import TimeloopHybridMapper
from .salsa import SalsaMapper

ALL_MAPPERS = {
    "goma": GomaMapper,
    "goma-eq": GomaEqMapper,
    "cosa": CosaLikeMapper,
    "factorflow": FactorFlowMapper,
    "loma": LomaMapper,
    "salsa": SalsaMapper,
    "timeloop-hybrid": TimeloopHybridMapper,
}

__all__ = ["Mapper", "MapperResult", "hw_default_residency", "ALL_MAPPERS",
           "GomaMapper", "GomaEqMapper", "CosaLikeMapper", "FactorFlowMapper", "LomaMapper",
           "SalsaMapper", "TimeloopHybridMapper"]
