"""Angle, geometry and small linear-algebra primitives."""
