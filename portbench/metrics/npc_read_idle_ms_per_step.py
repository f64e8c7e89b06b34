"""Device idle after the exact NPC loops' reads, in ms per window step: the
program's spans ``read_idle_s.cleanup`` and ``read_idle_s.cascade`` of the
env's ``npc_stats`` (each from a read of the cleanup's or the collision
cascade's work left, which drains the stream, to the return of the graph
replay after it; utils/graphs.py::Segments) over the window's steps. None
where the program keeps neither span (no exact NPC loops, an eager step, a
program without the spans)."""


def read(r):
    keys = ("read_idle_s.cleanup", "read_idle_s.cascade")
    if not any(k in r.npc_stats for k in keys):
        return None
    return 1e3 * sum(r.npc_stats.get(k, 0.0) for k in keys) / r.steps
