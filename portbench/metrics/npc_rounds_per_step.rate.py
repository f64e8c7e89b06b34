"""NPC loop rounds per window step, as npc_rounds_per_step reads them, in a
cell whose step tail is not compared, so that they move its rate: the exact
controller's cleanup rounds plus the collision cascade's rounds
(``cleanup_rounds`` and ``collision_rounds`` of the env's ``npc_stats``)
over the window's steps. None where the step runs no such loop."""


def read(r):
    keys = ("cleanup_rounds", "collision_rounds")
    if not any(k in r.npc_stats for k in keys):
        return None
    return sum(r.npc_stats.get(k, 0) for k in keys) / r.steps
