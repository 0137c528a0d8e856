"""Serving engine over the card's router (mirror of ``repro.serve``)."""
from .engine import EngineStats, Request, ServeEngine

__all__ = ["EngineStats", "Request", "ServeEngine"]
