"""Figures (``plots``), imported where a figure is drawn."""
