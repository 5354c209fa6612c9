"""Evaluation: Praat TextGrids, the ICSI transcripts, interval indices and
the time-weighted evaluator (no pandas, no lxml)."""
