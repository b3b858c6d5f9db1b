"""``spec_pairs_s``: seconds of the dense tip spec's static pair-butterfly
matrix C(W, 2) a decomposition (W = A·Aᵀ, then C(W, 2) in float64 on the
device, for CD's incremental §5.1 updates), the program's ``spec.pairs``
span (``seconds["spec.pairs"]``), the mean over the window's
decompositions.  Nothing to read where the program has no such span."""


def read(rec):
    ds = rec.get("decomps")
    if not ds or any("spec.pairs" not in d["seconds"] for d in ds):
        return None
    return sum(d["seconds"]["spec.pairs"] for d in ds) / len(ds)
