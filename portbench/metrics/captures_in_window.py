"""Graphs captured during the window: the graphs that the step's ``graphs``
holds at the window's close and did not at its start, told by identity
(run.py::graph_counts). A capture runs its segment eagerly and then
captures it, far slower than a replay, so each one costs the window a
capture's time. None where the step keeps no graphs."""


def read(r):
    if r.graphs_before is None:
        return None
    return float(r.graphs_after - r.graphs_before)
