"""Host-side data, numpy only, in the layout of ssdr_al_tpu/data/:
ply (PLY files), cloud (clouds and blocks), dataset (the training,
sampling and evaluation pipelines) and synthetic (generated rooms and
voxel-grid superpoints). Same random draws in the same order as the JAX
package, so the same seed gives the same arrays (tests/test_torch_data.py,
tests/test_torch_eval.py)."""
