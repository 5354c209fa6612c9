"""Audio decoding (SPHERE/WAV, embedded shorten)."""
