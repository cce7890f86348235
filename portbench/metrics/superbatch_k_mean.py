"""The mean number of batches a dispatch of the lane ring folded in the
measured window (its `superbatch_folds` by ladder entry k)."""


def read(run):
    a, b = run.after["superbatch_folds"], run.before["superbatch_folds"]
    folds = {k: n - b.get(k, 0) for k, n in a.items()}
    total = sum(folds.values())
    if total <= 0:
        return None
    return sum(k * n for k, n in folds.items()) / total
