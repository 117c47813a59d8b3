"""Featurization of atom14 trajectories."""
