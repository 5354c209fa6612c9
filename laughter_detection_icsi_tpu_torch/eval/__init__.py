"""Evaluation IO: Praat TextGrids."""
