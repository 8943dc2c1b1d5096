"""Exporters of predictions (PLY, Semantic3D .labels)."""
