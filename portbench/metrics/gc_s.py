"""``gc_s``: seconds of the cyclic GC's pauses inside the peel CLI's
``run()`` a decomposition, the program's ``gc.callbacks`` hook
(``seconds["gc"]``), the mean over the window's decompositions.
Nothing to read where the program has no such hook."""


def read(rec):
    ds = rec.get("decomps")
    if not ds or any("gc" not in d["seconds"] for d in ds):
        return None
    return sum(d["seconds"]["gc"] for d in ds) / len(ds)
