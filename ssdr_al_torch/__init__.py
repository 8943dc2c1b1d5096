"""PyTorch + CUDA port of ssdr_al_tpu for one NVIDIA H100.

Ported so far: the closed active-learning loop of the full SSDR
configuration at RandLA-Net S3DIS width: the seed round, then per round
restore → TSampler selection (sb / WetSU / clsbal / GCN-FPS / NAIL) →
retraining on the host pipeline → evaluation → best-mIoU snapshot
(cli/seed.py, cli/al_loop.py). The TPU's Pallas kernels on that path are
hand-written CUDA kernels (csrc/, built by kernels/build.py):

  K1 window top-k search   ops/knn.py::window_topk
  K2 windowed gather       ops/gather.py::gather_window (forward)
  K3 chamfer sums          ops/chamfer.py::chamfer_sums
  K4 windowed scatter-add  ops/gather.py::scatter_window (K2's backward)

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors. Entry points run on the card unless the caller
passes device="cpu" (device.py). The package imports torch and never jax,
and nothing of ssdr_al_tpu: it carries its own config (config.py) and host
data (data/).
"""
