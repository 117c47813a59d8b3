"""Utilities: weight conversion."""
