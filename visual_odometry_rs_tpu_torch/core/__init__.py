"""Camera model, inverse depth and candidate selection."""
