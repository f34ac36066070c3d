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


def reference_classes(name, keep, drop=(), subs=()):
    """The top-level classes and functions ``keep`` of ``tests/<name>``
    (with their decorators), the methods ``drop`` cut out (with theirs)
    and ``subs`` applied (each must apply once), compiled for a port test
    module to exec in its own namespace, where the reference's names are
    bound to the port's.  No name of the reference package may be left."""
    src = open(os.path.join(HERE, name), encoding="utf-8").read()
    out, take = [], False
    for ln in src.split("\n"):
        if ln and not ln[0].isspace() and not ln.startswith(")"):
            take = any(ln.startswith(f"class {c}") or
                       ln.startswith(f"def {c}(") for c in keep) \
                or (take and ln.startswith("@"))
        if take:
            out.append(ln)
    body = "\n".join(out)
    for m in drop:
        i = body.index(f"    def {m}(")
        while True:  # the method's own decorators go with it
            j = body.rfind("\n", 0, i - 1) + 1
            if not body[j:i].startswith("    @"):
                break
            i = j
        k = body.index(f"    def {m}(", i)
        ends = [e for e in (body.find("\n    def ", k + 1),
                            body.find("\n    @", k + 1),
                            body.find("\nclass ", k + 1)) if e >= 0]
        body = body[:i] + (body[min(ends) + 1:] if ends else "")
    for a, b in subs:
        assert body.count(a) == 1, a
        body = body.replace(a, b)
    assert "bigdl_tpu." not in body.replace("bigdl_tpu_torch.", "")
    return compile(body, os.path.join(HERE, name), "exec")
