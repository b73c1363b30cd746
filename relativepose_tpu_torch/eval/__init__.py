"""Evaluation: per-overlap-bucket pose errors."""
