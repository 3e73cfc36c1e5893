"""host_syncs_per_iter.train: the program's `host_sync` events (a device
value read on the host, which drains the device's queue) a traced
iteration, from their `cips.count.host_sync` markers."""

from portbench.lib.program_spans import per_unit_count


def read(run):
    return per_unit_count(run, "host_sync")
