"""Utilities: weight conversion, released-checkpoint reading, run logging."""
