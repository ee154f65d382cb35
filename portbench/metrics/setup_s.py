"""Seconds from the process's start to the window: imports, the kernel
library, construction, init, bootstrap, converge and the warm chunk."""


def read(rec):
    return rec["setup_s"]
