"""Weight interchange with the reference package."""

from bigdl_tpu_torch.interop.jax_weights import load_jax_params, to_jax_params

__all__ = ["load_jax_params", "to_jax_params"]
