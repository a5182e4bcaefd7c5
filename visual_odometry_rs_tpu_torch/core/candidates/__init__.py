"""Candidate-point selectors."""
