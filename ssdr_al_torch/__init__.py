"""PyTorch + CUDA port of ssdr_al_tpu for one NVIDIA H100.

Slice ported so far: one active-learning selection round of the full SSDR
configuration (TSampler with sb / WetSU / clsbal / GCN-FPS / NAIL) at
RandLA-Net S3DIS width. The TPU's Pallas kernels on that path are
hand-written CUDA kernels (csrc/, built by kernels/build.py):

  K1 window top-k search   ops/knn.py::window_topk
  K2 windowed gather       ops/gather.py::gather_window
  K3 chamfer sums          ops/chamfer.py::chamfer_sums

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors. The package imports torch and never jax, and
nothing of ssdr_al_tpu: it carries its own config (config.py) and host
data (data.py).
"""
