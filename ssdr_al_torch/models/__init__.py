"""RandLA-Net as torch.nn modules, with the sorted-space pyramid."""
