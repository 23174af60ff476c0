"""Predictive pre-warming & cross-worker container migration.

``estimator`` turns observed arrivals into per-function rate forecasts
(EWMA + Holt-Winters seasonal) and learned DAG-successor edges; ``planner``
turns a forecast + pool snapshot into a budget-feasible list of prewarm /
migrate / retire actions, validated with the real Listing-1 machinery.
"""
from .estimator import (
    ArrivalForecast,
    DecayingRate,
    MeanEstimate,
    SeasonalProfile,
    Successor,
    SuccessorStats,
)
from .planner import (
    ForecastPlanner,
    Migrate,
    PlanConfig,
    Prewarm,
    Retire,
)

__all__ = [
    "ArrivalForecast", "DecayingRate", "MeanEstimate", "SeasonalProfile",
    "Successor", "SuccessorStats",
    "ForecastPlanner", "PlanConfig", "Prewarm", "Migrate", "Retire",
]
