"""PyTorch + CUDA port of ssdr_al_tpu for one NVIDIA H100.

Ported so far: the offline preparation and superpoint partition
(cli/prepare.py, cli/superpoint.py, partition/), and the closed
active-learning loop of the full SSDR
configuration at RandLA-Net width for S3DIS, Semantic3D and SemanticKITTI:
the seed round, then per round restore → TSampler selection (sb / WetSU /
clsbal / GCN-FPS / NAIL) → retraining on the device training pool
(train/device_pool.py; Semantic3D's possibility-scheduled pool,
train/possibility_pool.py) or the host pipeline → evaluation →
best-mIoU snapshot (cli/seed.py, cli/al_loop.py), on every KNN engine,
on one device or data-parallel over torch.distributed ranks
(--num_devices, parallel/), and the standalone evaluation
(cli/evaluate.py), which reads the port's snapshots and JAX's
(train/flax_snapshot.py). Every Pallas kernel of the TPU package is a
hand-written CUDA kernel here (csrc/, built by kernels/build.py):

  K1 window top-k search   ops/knn.py::window_topk
  K2 windowed gather       ops/gather.py::gather_window (forward)
  K3 chamfer sums          ops/chamfer.py::chamfer_sums
  K4 windowed scatter-add  ops/gather.py::scatter_window (K2's backward)
  K5 window top-k, centred-product distance
                           ops/knn.py::window_topk(mxu=True)
  K6 exact tiled KNN       ops/knn.py::knn_tiled (the "pallas" engine,
                           and the partition's 46-NN graph)

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors. Entry points run on the card unless the caller
passes device="cpu" (device.py). The package imports torch and never jax,
and nothing of ssdr_al_tpu: it carries its own config (config.py) and host
data (data/).
"""
