"""Port-side twins of the JAX package's scripts/ that drive it end to end
(scripts/ablation.py → scripts.ablation)."""
