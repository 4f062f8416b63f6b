"""Seconds of the program's host pack, ``build_wplan``, on the host clock."""


def read(run):
    return run.pack_s
