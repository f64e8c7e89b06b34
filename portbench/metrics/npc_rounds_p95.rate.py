"""The 95th percentile of the exact NPC loops' rounds in a window step, as
npc_rounds_p95 reads it, in a cell whose step tail is not compared, so
that it moves its rate: from the window's change in the program's histogram
``npc_rounds_at_<n>`` of the env's ``npc_stats`` (ticks that ran n rounds),
by numpy's linear rule on the expanded counts. None where the program keeps
no such histogram or the window ran no tick."""
import numpy as np

PREFIX = "npc_rounds_at_"


def read(r):
    hist = {int(k[len(PREFIX):]): int(v) for k, v in r.npc_stats.items()
            if k.startswith(PREFIX)}
    if sum(hist.values()) <= 0:
        return None
    rounds = sorted(hist)
    return float(np.percentile(np.repeat(rounds, [hist[n] for n in rounds]), 95))
