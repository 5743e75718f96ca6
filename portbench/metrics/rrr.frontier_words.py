"""Words the sampler's BFS steps pushed a selection: the program's
``frontier_words`` (the lengths of the live-word lists, the roots'
included) over the window's selections."""


def read(run):
    if "frontier_words" not in run.stats or not run.units:
        return None
    return run.stats["frontier_words"] / run.units
