"""Numeric-failure policy of the training driver (port of
``bigdl_tpu/resilience/numeric.py``).

``Optimizer.set_numeric_guard`` / ``Config.numeric_guard`` picks what a
non-finite loss or gradient does.  The per-step finite flags are computed
on the card inside the step and ride the same one-block-behind fetch as
the losses, so no policy adds a host sync:

- ``"off"`` (default): the step is built exactly as without a guard (the
  same losses bitwise, the same launches);
- ``"skip"``: the step's update of the parameters and the optimizer state
  is dropped on the card (``torch.where`` against the pre-step values),
  the step is counted in ``resilience/steps_skipped`` and training goes on;
- ``"rollback"``: the replay raises :class:`NonFiniteStepError`; the
  optimizer restores the latest valid snapshot and runs again, at most
  ``Config.failure_retry_times`` times;
- ``"abort"``: the replay raises and nothing catches it: the run fails at
  the exact iteration.
"""

from __future__ import annotations

NUMERIC_POLICIES = ("off", "skip", "rollback", "abort")


class NonFiniteStepError(RuntimeError):
    """A training step produced a non-finite loss or gradient and the
    policy wants the run stopped (``rollback``, caught by the optimizer's
    restore loop, or ``abort``, surfaced to the caller)."""

    def __init__(self, step: int, loss: float, policy: str):
        self.step = int(step)
        self.loss = float(loss)
        self.policy = policy
        super().__init__(
            f"non-finite training step at iteration {step} "
            f"(loss={loss}); numeric_guard policy is {policy!r}")


def validate_policy(policy: str, source: str = "numeric_guard") -> str:
    if policy not in NUMERIC_POLICIES:
        raise ValueError(
            f"{source} must be one of {NUMERIC_POLICIES}, got {policy!r}")
    return policy
