"""Learning-rate schedules (a copy of ``msd_tpu/lr_schedules.py``).

Behavioral parity with the reference's four schedule types
(ref: deep_sdf/lr_scheduling.py:6-108). Schedules are host-side objects:
the trainer reads the scalar LR of each epoch from them, so plateau logic
(which inspects the loss log) stays in Python, exactly like the reference.
"""

from __future__ import annotations


class LearningRateSchedule:
    def get_learning_rate(self, epoch, *args, **kwargs):
        raise NotImplementedError


class ConstantLearningRateSchedule(LearningRateSchedule):
    """ref: deep_sdf/lr_scheduling.py:6-11."""

    def __init__(self, value):
        self.value = value

    def get_learning_rate(self, epoch, *args, **kwargs):
        return self.value


class StepLearningRateSchedule(LearningRateSchedule):
    """initial * factor ** (epoch // interval) (ref: lr_scheduling.py:14-22)."""

    def __init__(self, initial, interval, factor):
        self.initial = initial
        self.interval = interval
        self.factor = factor

    def get_learning_rate(self, epoch, *args, **kwargs):
        return self.initial * (self.factor ** (epoch // self.interval))


class StepLearningRateOnPlateauSchedule(LearningRateSchedule):
    """Reduce LR when the epoch-loss log stops improving
    (ref: lr_scheduling.py:25-55). Stateful: tracks last LR and last step
    epoch; ``set_state`` supports resume (the reference reseeds from the
    optimizer LR on resume, train_deep_sdf.py:483-485).
    """

    def __init__(self, initial, factor, patience, threshold, min_lr, cooldown=0):
        self.initial = initial
        self.min_lr = min_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.last_lr = initial
        self.last_step_epoch = -99999
        self.cooldown = cooldown if cooldown is not None else 0

    def set_state(self, last_lr, last_step_epoch=-99999):
        self.last_lr = last_lr
        self.last_step_epoch = last_step_epoch

    def get_learning_rate(self, epoch, loss_log=(), *args, **kwargs):
        loss_log = list(loss_log)
        if len(loss_log) > self.patience and epoch - self.last_step_epoch > self.cooldown:
            before_patience_min = min(loss_log[: -self.patience])
            in_patience_min = min(loss_log[-self.patience :])
            if before_patience_min - in_patience_min <= self.threshold:
                self.last_lr *= self.factor
                self.last_step_epoch = epoch
        return max(self.last_lr, self.min_lr)


class WarmupLearningRateSchedule(LearningRateSchedule):
    """Linear warmup then constant (ref: lr_scheduling.py:58-67)."""

    def __init__(self, initial, warmed_up, length):
        self.initial = initial
        self.warmed_up = warmed_up
        self.length = length

    def get_learning_rate(self, epoch, *args, **kwargs):
        if epoch > self.length:
            return self.warmed_up
        return self.initial + (self.warmed_up - self.initial) * epoch / self.length


def get_learning_rate_schedules(specs):
    """Factory over specs["LearningRateSchedule"] — a list of dicts
    [network schedule, latent-code schedule] (ref: lr_scheduling.py:70-108).
    """
    schedule_specs = specs["LearningRateSchedule"]
    assert schedule_specs != [], (
        "LearningRateSchedule NEEDS TO CONTAIN TWO DICTS BUT WAS EMPTY."
    )

    schedules = []
    for s in schedule_specs:
        typ = s["Type"]
        if typ == "Step":
            schedules.append(StepLearningRateSchedule(s["Initial"], s["Interval"], s["Factor"]))
        elif typ == "Warmup":
            schedules.append(WarmupLearningRateSchedule(s["Initial"], s["Final"], s["Length"]))
        elif typ == "Constant":
            schedules.append(ConstantLearningRateSchedule(s["Value"]))
        elif typ == "StepOnPlateau":
            schedules.append(
                StepLearningRateOnPlateauSchedule(
                    s["Initial"],
                    s["Factor"],
                    s["Patience"],
                    s["Threshold"],
                    s["MinLR"],
                    s.get("Cooldown"),
                )
            )
        else:
            raise Exception(f'no known learning rate schedule of type "{typ}"')
    return schedules
