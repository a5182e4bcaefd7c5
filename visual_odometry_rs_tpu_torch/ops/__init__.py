"""Image ops and the fused LM evaluation kernel."""
