"""Geometry: rigid transforms, residue tables, frames/torsions/atoms."""
