"""Seconds a batched solve takes: the service's ``solve_s`` (its clocks
synchronize the card) over its ``solves``."""


def read(run):
    if not run.stats.get("solves"):
        return None
    return run.stats["solve_s"] / run.stats["solves"]
