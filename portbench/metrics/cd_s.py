"""``cd_s``: seconds of the coarse-grained phase (``peelspec.cd_loop``) a
decomposition, ``PeelResult.seconds["cd"]``, the mean over the window's
decompositions."""


def read(rec):
    ds = rec.get("decomps")
    if not ds:
        return None
    return sum(d["seconds"]["cd"] for d in ds) / len(ds)
