"""`torch.cuda.max_memory_allocated` over the window (reset at the end of
set-up), in MiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 20
