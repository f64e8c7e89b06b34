"""NPC loop rounds per window step: the exact controller's cleanup rounds
plus the collision cascade's rounds (``cleanup_rounds`` and
``collision_rounds`` of the env's ``npc_stats``) over the window's steps.
None where the step runs no such loop (no NPC traffic)."""


def read(r):
    keys = ("cleanup_rounds", "collision_rounds")
    if not any(k in r.npc_stats for k in keys):
        return None
    return sum(r.npc_stats.get(k, 0) for k in keys) / r.steps
