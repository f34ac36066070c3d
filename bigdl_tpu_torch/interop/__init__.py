"""Weight interchange with the reference package."""

from bigdl_tpu_torch.interop.jax_weights import (from_jax_tree, jax_tree,
                                                 load_jax_params,
                                                 to_jax_params)

__all__ = ["from_jax_tree", "jax_tree", "load_jax_params", "to_jax_params"]
