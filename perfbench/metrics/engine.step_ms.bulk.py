"""The window's host-clock seconds per batch, from the host-to-device
copy to the box rows on the host."""


def read(rec):
    win = rec["window"]
    return win.seconds / win.batches * 1e3 if win.batches else None
