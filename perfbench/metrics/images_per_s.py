"""Images whose boxes reached the host, over the window's seconds (the
window ends with the last batch it started)."""


def read(rec):
    win = rec["window"]
    return win.images / win.seconds if win.images else None
