"""Dtype policy and device resolution."""
