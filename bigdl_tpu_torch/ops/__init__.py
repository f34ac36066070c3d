"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from bigdl_tpu_torch.ops.embed_bag import embedding_bag_coo

__all__ = ["embedding_bag_coo"]
