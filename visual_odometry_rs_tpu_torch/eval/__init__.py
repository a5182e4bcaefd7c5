"""Trajectory metrics."""
