"""Curve sorts and KNN (K1, K5, K6), windowed gather (K2, K4), chamfer (K3),
segments, FPS."""
