"""TUM RGB-D IO and synthetic sequences."""
