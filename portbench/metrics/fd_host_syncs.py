"""``fd_host_syncs``: reads from the device to the host that the FD
drivers make a decomposition: the program's process-wide counts
``obs.counts()["fd.host_syncs"]`` over ``["peel.decompositions"]``.  A
run is one process and every decomposition of it peels the same graph,
so the ratio is exact.  Nothing to read where the program keeps no such
counts."""


def read(rec):
    from repro_torch import obs

    counts = getattr(obs, "counts", None)
    if counts is None:
        return None
    c = counts()
    if not c.get("peel.decompositions") or "fd.host_syncs" not in c:
        return None
    return c["fd.host_syncs"] / c["peel.decompositions"]
