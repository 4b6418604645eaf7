"""The benchmark's host-clock span around ``RegistrationPipeline.register``
until it returns, before the synchronisation: the window's total over its
requests, in ms."""


def read(rec):
    if rec["kind"] != "register" or not rec.get("enqueue_s"):
        return None
    return 1e3 * sum(rec["enqueue_s"]) / len(rec["enqueue_s"])
