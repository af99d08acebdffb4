"""The allocator's peak over the run up to the window's close, in GiB."""


def read(r):
    return r.peak_bytes / 2**30 if r.peak_bytes else None
