"""Seconds a selection spends in its selector calls: the program's
``select_s`` (its clocks synchronize the card) over the window's
selections."""


def read(run):
    if "select_s" not in run.stats or not run.units:
        return None
    return run.stats["select_s"] / run.units
