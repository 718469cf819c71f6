"""launches_per_job: the card's kernels, copies and fills in the traced
window per job (host dispatch); it repeats exactly where the jobs do."""


def read(window):
    if not window.events or not window.jobs:
        return None
    return len(window.events) / window.jobs
