"""setup_s: the process's start to the window's start (host clock)."""


def read(rec):
    return rec.get("setup_s")
