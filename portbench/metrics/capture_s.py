"""Seconds the set-up spent capturing CUDA graphs: the sum of ``Graph.capture_s``
(utils/graphs.py) over the graphs that the step's ``graphs`` holds when the
window starts. None where the step keeps no graphs."""


def read(r):
    return r.capture_s
