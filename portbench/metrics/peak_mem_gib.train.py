"""The allocator's counter ``torch.cuda.max_memory_allocated()`` over
set-up and window, the largest over ranks, in GiB."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["peak"] / 2 ** 30
