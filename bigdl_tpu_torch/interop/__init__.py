"""Model import/export and weight interchange.

The model files BigDL reads and writes — its own protobuf format
(``bigdl_format``), Caffe (``caffe_format``/``caffe_export``), Torch7
(``torch_format``/``torch_export``) and TensorFlow GraphDefs
(``tf_format``/``tf_export``), Keras 1.2 JSON definitions and HDF5
weights (``keras_format``) — and the reference package's weight trees
(``jax_weights``).  The loaders build port modules on the CPU; move the
model to its device afterwards (``ModelRegistry.deploy(path=, format=)``
and ``convert_model --device`` do).  ``TFSession`` (``session``) trains an
imported GraphDef, queue-fed ones through ``tf_queues.QueuePipeline``.
"""

from bigdl_tpu_torch.interop.bigdl_format import (decode_bigdl_module,
                                                  load_bigdl_module,
                                                  save_bigdl_module)
from bigdl_tpu_torch.interop.caffe_export import save_caffe
from bigdl_tpu_torch.interop.caffe_format import load_caffe_model
from bigdl_tpu_torch.interop.keras_format import (load_keras_hdf5_weights,
                                                  load_keras_json,
                                                  set_keras_weights)
from bigdl_tpu_torch.interop.jax_weights import (from_jax_tree, jax_tree,
                                                 load_jax_params,
                                                 to_jax_params)
from bigdl_tpu_torch.interop.tf_export import save_tf_graph
from bigdl_tpu_torch.interop.tf_format import load_tf_graph
from bigdl_tpu_torch.interop.torch_export import (load_torch_module,
                                                  save_torch_module)
from bigdl_tpu_torch.interop.torch_format import load_t7, save_t7

__all__ = ["decode_bigdl_module", "from_jax_tree", "jax_tree",
           "load_bigdl_module", "load_caffe_model", "load_jax_params",
           "load_keras_hdf5_weights", "load_keras_json",
           "load_t7", "load_tf_graph", "load_torch_module", "save_bigdl_module",
           "save_caffe", "save_t7", "save_tf_graph", "save_torch_module",
           "set_keras_weights", "to_jax_params"]


def __getattr__(name):
    # the session trains through optim, which imports this package: load
    # it on first use
    if name in ("TFSession", "QueuePipeline"):
        from bigdl_tpu_torch.interop import session, tf_queues
        return session.TFSession if name == "TFSession" \
            else tf_queues.QueuePipeline
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
