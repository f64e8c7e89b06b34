"""The share of the window's steps, in %, that the program ran at an NPC
width above the narrowest width its counters name (``step_width_<w>``,
IntersectionEnv.npc_stats): the steps at which some env held more NPCs than
the narrow width, whose NPC update and lidar cost more. None where the
counters name no width."""


def read(r):
    widths = {int(k[len("step_width_"):]): n for k, n in r.npc_stats.items()
              if k.startswith("step_width_")}
    total = sum(widths.values())
    if not total:
        return None
    return 100.0 * (total - widths[min(widths)]) / total
