"""AL state, oracle, uncertainty, region graph, GCN-FPS and the samplers."""
