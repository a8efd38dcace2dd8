"""Process start to the first timed request: CUDA start, seeded weights,
the request pool, the cell's engines warmed, the kernel library loaded."""


def read(rec):
    return rec["setup_s"]
