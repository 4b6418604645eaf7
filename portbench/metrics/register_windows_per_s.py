"""Windows registered (rendered, embedded, matched, top-k on the host) in
the window, over the window's seconds (host clock)."""


def read(rec):
    if rec["kind"] != "register":
        return None
    return rec["samples"] / rec["window_s"]
