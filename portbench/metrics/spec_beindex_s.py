"""``spec_beindex_s``: seconds of the BE-Index build
(``beindex.build_beindex``, host Python) a decomposition, the program's
``spec.beindex`` span (``seconds["spec.beindex"]``), the mean over the
window's decompositions.  Nothing to read where the program has no such
span."""


def read(rec):
    ds = rec.get("decomps")
    if not ds or any("spec.beindex" not in d["seconds"] for d in ds):
        return None
    return sum(d["seconds"]["spec.beindex"] for d in ds) / len(ds)
