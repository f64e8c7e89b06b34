"""The 95th percentile of the exact NPC loops' rounds in a window step: the
cleanup's and the collision cascade's rounds of one tick together, from
the window's change in the program's histogram ``npc_rounds_at_<n>`` of the
env's ``npc_stats`` (ticks that ran n rounds), by numpy's linear rule on
the expanded counts. None where the program keeps no such histogram (no
exact NPC loops, a program without it) or the window ran no tick."""
import numpy as np

PREFIX = "npc_rounds_at_"


def read(r):
    hist = {int(k[len(PREFIX):]): int(v) for k, v in r.npc_stats.items()
            if k.startswith(PREFIX)}
    if sum(hist.values()) <= 0:
        return None
    rounds = sorted(hist)
    return float(np.percentile(np.repeat(rounds, [hist[n] for n in rounds]), 95))
