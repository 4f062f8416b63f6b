"""Set-up seconds: from the start of the run's process to the start of the
window (imports, builds on a first run, matrix, pack, operator, warm-up)."""


def read(run):
    return run.setup_s
