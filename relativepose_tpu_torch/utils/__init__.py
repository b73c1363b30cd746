"""Weight-file helpers (numpy)."""
