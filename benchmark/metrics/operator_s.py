"""Seconds of ``SpMVOperator(plan, ...)`` up to a synchronize: lowering,
upload and K6's schedule, on the host clock."""


def read(run):
    return run.operator_s
