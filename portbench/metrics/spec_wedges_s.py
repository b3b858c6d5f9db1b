"""``spec_wedges_s``: seconds of the csr spec's wedge list
(``csr.build_wedges``, host numpy) a decomposition, the program's
``spec.wedges`` span (``seconds["spec.wedges"]``), the mean over the
window's decompositions.  Nothing to read where the program has no such
span."""


def read(rec):
    ds = rec.get("decomps")
    if not ds or any("spec.wedges" not in d["seconds"] for d in ds):
        return None
    return sum(d["seconds"]["spec.wedges"] for d in ds) / len(ds)
