"""Host milliseconds of ``StorePlacement.plan_migration`` after a burst
(the registered keys up, four launches, the plan copied back), the mean
over the traced run's measured window."""


def read(run):
    return run.mean(run.window.replan_s, 1e3)
