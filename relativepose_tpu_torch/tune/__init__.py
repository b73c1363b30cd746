"""Sigma tuning: the solver's matching sigmas fitted per recurrence level."""
