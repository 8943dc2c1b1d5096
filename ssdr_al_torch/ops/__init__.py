"""Morton sort, window KNN (K1), windowed gather (K2), chamfer (K3), segments, FPS."""
