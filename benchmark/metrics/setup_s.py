"""Seconds from the start of the process to the window: imports, kernels from
the build cache, weights drawn on the card, the sampler (and a seeded state
written and resumed), the warm-up of the cell's shapes."""


def read(rec):
    return rec["setup_s"]
