"""Synthetic scenes and dataset adapters (numpy), sigma tables."""
