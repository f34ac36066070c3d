"""lockdep in the port (``bigdl_tpu_torch/utils/lockdep.py``): the
reference's own cases (``tests/test_lockdep.py``: cycle detection, no
false positives, slow holds, inertness with the port's ``LocalOptimizer``,
lifecycle) run against the port's copy — the reference file's source,
with its imports pointed at the port, is executed into this module — and
the port's config gate arms it."""

import threading

import pytest

pytest.importorskip("jax")  # the reference's tests sit beside it

from torch_reference_cases import PORTED, load_reference_cases  # noqa: E402

exec(load_reference_cases(  # noqa: S102
    "test_lockdep.py",
    [p for p in PORTED if "spmdcheck" not in p[0]
     and "get_config" not in p[0]]
    + [("from bigdl_tpu.utils import lockdep",
        "from bigdl_tpu_torch.utils import lockdep")]))


@needs_isolation  # noqa: F821 - defined by the reference's cases
def test_port_config_and_hold_threshold_arm_the_ports_copy():
    from bigdl_tpu_torch.utils import config
    config.configure(lockdep=True, lockdep_hold_ms=5.0)
    try:
        assert lockdep.maybe_install() is True  # noqa: F821
        assert threading.Lock is lockdep._lock_factory  # noqa: F821
        assert lockdep._STATE.hold_threshold_s == 0.005  # noqa: F821
    finally:
        config.reset_config()
        lockdep.uninstall()  # noqa: F821
        lockdep.reset()  # noqa: F821
    assert threading.Lock is lockdep._ORIG_LOCK  # noqa: F821
