"""Training: losses, the feature-net and completion-net steps."""
