"""Device reads by the host per window step: ``host_reads`` of the env's
``npc_stats`` (the NPC width read, the exact NPC loops' reads) over the
window's steps. Each read waits for the stream to drain. None where the
step makes no such read (no NPC traffic)."""


def read(r):
    reads = r.npc_stats.get("host_reads")
    return reads / r.steps if reads else None
