"""``fd_s``: seconds of the fine-grained phase (``peelspec.run_fd`` and
its drivers) a decomposition, ``PeelResult.seconds["fd"]``, the mean
over the window's decompositions."""


def read(rec):
    ds = rec.get("decomps")
    if not ds:
        return None
    return sum(d["seconds"]["fd"] for d in ds) / len(ds)
