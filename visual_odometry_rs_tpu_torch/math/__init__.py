"""Pose algebra, so3/se3 and the LM optimizer harness."""
