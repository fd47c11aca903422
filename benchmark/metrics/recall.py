"""recall: the mean recall@k of the window's queries against the plain
reference's exact top-k (over every request, or the harness's seeded
sample of them)."""


def read(run):
    return run.recall
