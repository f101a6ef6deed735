"""Evaluation harnesses (RULER-equivalent synthetic long-context suite)."""
