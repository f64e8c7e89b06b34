"""Device idle after the NPC width read, in ms per window step: the
program's span ``read_idle_s.width`` of the env's ``npc_stats`` (from the
host's read of the width, which drains the stream, to the return of the
graph replay after it; utils/graphs.py::Segments) over the window's steps.
None where the program keeps no such span (no NPC traffic, an eager step,
a program without the spans)."""


def read(r):
    seconds = r.npc_stats.get("read_idle_s.width")
    return None if seconds is None else 1e3 * seconds / r.steps
