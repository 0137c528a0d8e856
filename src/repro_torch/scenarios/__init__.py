"""Scenario realization (the ``uniform`` scenario; see build.py)."""
from .build import ScenarioData, realize

__all__ = ["ScenarioData", "realize"]
