"""Simulation drivers and metrics."""
