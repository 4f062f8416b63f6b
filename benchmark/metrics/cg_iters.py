"""Mean CG iterations per solve in the window (the solver's count)."""


def read(run):
    if not run.iters:
        return None
    return sum(run.iters) / len(run.iters)
