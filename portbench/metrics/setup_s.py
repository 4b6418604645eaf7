"""Seconds from the process's start (the launcher's, on several chips) to
the start of the window."""


def read(rec):
    return rec["setup_s"]
