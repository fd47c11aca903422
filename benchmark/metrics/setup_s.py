"""setup_s: process start to window open (host clock): the corpus and the
query pool, the ingest and index build, the threshold flush, the kernel
build where it runs, and the warm-up requests."""


def read(run):
    return run.setup_s
