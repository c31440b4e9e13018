"""setup_s: process start through the warm-up trees on every rank:
imports, spawning, the process group, the dataset made from the seed, the
kernel's build or load, and one warm-up tree a gradient set."""


def read(r):
    return r.setup_s
