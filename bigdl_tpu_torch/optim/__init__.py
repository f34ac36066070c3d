"""Training of the port (``bigdl_tpu.optim`` twins)."""

from bigdl_tpu_torch.optim.optim_method import SGD, Adam, OptimMethod
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             clip_by_global_norm,
                                             clip_by_value, global_norm)
from bigdl_tpu_torch.optim.schedules import (Default, EpochDecay,
                                             EpochDecayWithWarmUp,
                                             EpochSchedule, EpochStep,
                                             Exponential, LearningRateSchedule,
                                             MultiStep, NaturalExp, Plateau,
                                             Poly, SequentialSchedule, Step,
                                             Warmup)
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch, max_epoch,
                                           max_iteration, max_score,
                                           min_loss, probe_fire_step,
                                           several_iteration)
from bigdl_tpu_torch.optim.validation import (MAE, NDCG, HitRatio, Loss,
                                              Top1Accuracy, Top5Accuracy,
                                              TreeNNAccuracy,
                                              ValidationMethod,
                                              ValidationResult)

__all__ = ["Adam", "Default", "EpochDecay", "EpochDecayWithWarmUp",
           "EpochSchedule", "EpochStep", "Exponential", "HitRatio",
           "LearningRateSchedule", "LocalOptimizer", "Loss", "MAE",
           "MultiStep", "NDCG", "NaturalExp", "OptimMethod", "Optimizer",
           "Plateau", "Poly", "SGD", "SequentialSchedule", "Step",
           "Top1Accuracy", "Top5Accuracy", "TreeNNAccuracy", "Trigger",
           "ValidationMethod", "ValidationResult", "Warmup",
           "clip_by_global_norm", "clip_by_value", "every_epoch",
           "global_norm", "max_epoch", "max_iteration", "max_score",
           "min_loss", "probe_fire_step", "several_iteration"]
