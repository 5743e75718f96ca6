"""Seconds a selection spends sampling: the program's ``sample_s`` (its
clocks synchronize the card) over the window's selections."""


def read(run):
    if "sample_s" not in run.stats or not run.units:
        return None
    return run.stats["sample_s"] / run.units
