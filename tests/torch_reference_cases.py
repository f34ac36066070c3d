"""Helpers of ``tests/test_torch_spmdcheck.py`` and
``tests/test_torch_lockdep.py``: the reference's test source with its
imports pointed at the port, compiled for a port test module to run."""

import os

HERE = os.path.dirname(os.path.abspath(__file__))

#: the reference's imports and constructor calls -> the port's
PORTED = [
    ("from bigdl_tpu import nn, optim",
     "from bigdl_tpu_torch import nn, optim"),
    ("from bigdl_tpu.dataset.dataset import DataSet",
     "from bigdl_tpu_torch.dataset.dataset import DataSet"),
    ("from bigdl_tpu.dataset.transformer import Sample, SampleToMiniBatch",
     "from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch"),
    ("from bigdl_tpu.utils import spmdcheck",
     "from bigdl_tpu_torch.utils import spmdcheck"),
    ("from bigdl_tpu.utils.config import configure, reset_config",
     "from bigdl_tpu_torch.utils.config import configure, reset_config"),
    ("from bigdl_tpu.utils.config import get_config",
     "from bigdl_tpu_torch.utils.config import get_config"),
    ("                                nn.ClassNLLCriterion())\n",
     "                                nn.ClassNLLCriterion(), device=\"cpu\")\n"),
]


def load_reference_cases(name, ported, drop=()):
    """The source of ``tests/<name>`` with ``ported`` substitutions made
    (each must apply) and the classes in ``drop`` cut out."""
    src = open(os.path.join(HERE, name)).read()
    for a, b in ported:
        assert a in src, a
        src = src.replace(a, b)
    for cls in drop:
        i = src.index(f"class {cls}")
        j = src.find("\nclass ", i + 1)
        src = src[:i] + (src[j + 1:] if j >= 0 else "")
    return compile(src, os.path.join(HERE, name), "exec")
