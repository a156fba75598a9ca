"""Figures (``plots``) and the frame movie (``movie``), imported where a
figure is drawn."""
